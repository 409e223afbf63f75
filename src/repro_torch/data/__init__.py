"""Rating data: COO/CSR, nnz-bucketing and synthetic generators (numpy on the host)."""
