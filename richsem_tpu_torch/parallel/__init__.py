"""Data parallelism across processes, one a card (counterpart of ``richsem_tpu/parallel/``)."""
