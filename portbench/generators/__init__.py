"""Pattern generators, one module each, found by the name a configuration
gives (``"generator"``).  Each exposes ``generate(seed, **params)`` returning
``(n, indptr, indices)``: a structural CSR with every diagonal entry."""
