from lanczos_tpu.utils.timing import card_line, per_iteration, require_gpu, steady

__all__ = ["card_line", "per_iteration", "require_gpu", "steady"]
