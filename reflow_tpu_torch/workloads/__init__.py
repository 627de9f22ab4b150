"""Workloads ported so far: ``knn`` — k-NN re-index on embedding deltas
(BASELINE.md config 4); ``pagerank`` — incremental PageRank under edge
churn (config 3); ``wordcount`` (config 1); ``tfidf`` — streaming TF-IDF
over document edits (config 2); ``sssp`` — incremental single-source
shortest paths, the min-Reduce loop; ``image_embed`` — ViT feature
extraction feeding an incremental groupby-mean (config 5)."""
