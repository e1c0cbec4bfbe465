from .ops import SSDChunk, ssd_chunk, ssd_chunk_backward, ssd_chunk_cost, ssd_chunk_ref
