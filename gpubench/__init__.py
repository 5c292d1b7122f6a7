"""The benchmark of ``bp_from_video_tpu_torch`` on one NVIDIA H100
(``python3 -m gpubench``; see ``run.py``).  Configurations, traffic mixes
and per-layer metrics are files of their own under ``configs/``,
``traffic/`` and ``metrics/``, found by the names in ``BENCHMARK.json``;
each configuration names its system under ``systems/``, which builds,
drives, judges and counts it; ``ref/`` is the frozen plain reference that
decides ``correct`` for the flagship."""
