from .ops import event_scatter, event_scatter_ref
