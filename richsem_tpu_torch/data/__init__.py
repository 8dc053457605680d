"""The host input pipeline and the evaluators (counterpart of ``richsem_tpu/data``)."""
