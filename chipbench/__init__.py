"""The benchmark of ``repro_torch``: spike-train arrays mined on one card.

``run.py`` is the entry point; everything a configuration, a firing
model, a traffic mix, a loop driver or a metric needs sits in a file of
its own under ``configs/``, ``generators/``, ``traffic/``, ``drivers/``,
``end_to_end/`` and ``layer_metrics/``, found by the name that
``BENCHMARK.json`` or the configuration gives it.
"""
