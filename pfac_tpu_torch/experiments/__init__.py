"""Table-probe micro-benchmarks on the card: the counterparts of the
reference's TPU gather micro-benchmarks in ``experiments/`` (E1-E6).

``gathers`` holds the four kernels (G1-G4, ``csrc/gather_micro.cu``) and
their plain versions; each other module ports one reference script, under
its name, and runs on a GPU as

    python -m pfac_tpu_torch.experiments.<name>

(from the repository's root), printing one line per case: the CUDA-event
median, G lookups/s, the plain version's time, and ``equal=True``.
"""
