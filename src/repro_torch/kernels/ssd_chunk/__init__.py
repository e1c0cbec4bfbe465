from .ops import ssd_chunk, ssd_chunk_ref
