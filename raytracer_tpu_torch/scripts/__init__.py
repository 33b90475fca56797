"""The card probes and the roofline of the port, each a counterpart of a
TPU microbenchmark in ``scripts/``, run as
``python -m raytracer_tpu_torch.scripts.<name>`` (``--device cpu`` for
the plain PyTorch versions):

- :mod:`.bench_bf16_chain` — the independent-chain issue-rate probe, float32
  and bf16 (``scripts/bench_bf16_vpu.py``; also the chain of
  ``scripts/roofline.py``);
- :mod:`.probe_gather` — gathers from a shared-memory table and their
  one-hot reconstruction (``scripts/probe_mosaic_gather.py``);
- :mod:`.bench_scan_layout` — the closest-hit scan over slots in shared
  memory at four unroll blocks (``scripts/bench_scan_layout.py``);
- :mod:`.roofline` — the measured issue line and the cover's flat-scan
  render against it (``scripts/roofline.py``).
"""
