from .ops import sparse_gather, sparse_gather_ref
