"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It needs as many CUDA cards as the cell asks
for, and exits with 2 and no result without them. The last line of
standard output is the result (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``); the last
lines of standard error are the numbers compared, each beside its limit.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "adaqp_tpu")


def _caches() -> None:
    """Kernel, build and bytecode caches at fixed paths inside the checkout.
    Python's bytecode goes there too: where the installed packages hold
    none, every process would compile torch's modules from source again,
    some seconds of set-up that vary from run to run."""
    cache = os.path.join(ROOT, "benchmark", "cache")
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"] = os.path.join(cache, "pycache")
    sys.dont_write_bytecode = False
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the checkout's root, not this folder, heads the path: the harness's
    # modules are imported as benchmark.* and never shadow the stdlib's
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    _caches()
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    if cell["chips"] == 1:
        torch.cuda.set_device(0)  # at K>1 this process leaves the cards to the ranks
    out, rec = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", STARTED)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}", file=sys.stderr)
        return 3
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     **out["device"], "power": harness.power_limit()}
    print(json.dumps({k: rec[k] for k in (
        "losses", "nodes", "edges", "start_s", "graph_s", "trainer_init_s", "warmup_s",
        "setup_s", "window_s", "attempted", "reference_s")}), file=sys.stderr)
    for row in out["check"]:
        print(f"check {row['name']} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
