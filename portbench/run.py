"""The benchmark of the PyTorch and CUDA port of DISSECT-CF.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the CUDA card of this machine and
prints one JSON line: whether the answers were correct, the cell's
end-to-end metrics (``--trace 0``) or per-layer metrics (``--trace 1``),
and the device.  Exits with a code other than 0, and prints no result,
without a CUDA card, without the port beside it, or when JAX or the JAX
package was loaded.
"""
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    # the build and kernel caches of the program stay inside the checkout,
    # at fixed paths, so that only a checkout's first run builds
    cache = ROOT / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness
    sys.exit(harness.main())
