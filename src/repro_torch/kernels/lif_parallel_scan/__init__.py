from .ops import lif_parallel_scan, lif_parallel_scan_ref
