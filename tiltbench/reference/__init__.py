"""Plain references of the benchmark's queries: plain PyTorch, written from
each query's published description, importing nothing of the port."""
