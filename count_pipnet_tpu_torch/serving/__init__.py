from .engine import ServingEngine, autotune_batch_size

__all__ = ["ServingEngine", "autotune_batch_size"]
