from .ops import lif_update, lif_update_ref
