"""The card's calibration probes (counterparts of the Pallas probes in ``tools/``)
and the eval and input-pipeline benches (of ``tools/bench_eval.py`` and
``tools/bench_input_pipeline.py``)."""
