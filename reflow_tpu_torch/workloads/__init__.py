"""Workloads ported so far: ``knn`` — k-NN re-index on embedding deltas
(BASELINE.md config 4)."""
