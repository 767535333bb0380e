"""The benchmark's command: one run of one cell.

    python3 pfac_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints, as the last line of standard output, one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``), and the numbers compared with their
limits as the last lines of standard error. Exits 2 without a result where
the machine has fewer CUDA devices than the cell asks for, and 3 where JAX
or the JAX package was loaded. ``python3 -m pfac_bench.run`` is the same.
"""
import os
import sys
import time


def _process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROCESS = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel caches at fixed paths inside the checkout (the program's own build
# directory, pfac_tpu_torch/_build/, is one already)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "pfac_bench", "_cache",
                                              "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "pfac_bench",
                                                  "_cache", "extensions")

if __name__ == "__main__":
    sys.path[0] = ROOT
    from pfac_bench.harness import main
    sys.exit(main(sys.argv[1:], t_process=T_PROCESS))
