from .segment import masked_segment_sum

__all__ = ["masked_segment_sum"]
