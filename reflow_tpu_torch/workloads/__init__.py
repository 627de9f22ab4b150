"""Workloads ported so far: ``knn`` — k-NN re-index on embedding deltas
(BASELINE.md config 4); ``pagerank`` — incremental PageRank under edge
churn (BASELINE.md config 3)."""
