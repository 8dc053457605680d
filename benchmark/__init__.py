"""The benchmark of the PyTorch port ``richsem_tpu_torch`` (see ``README.md``)."""
