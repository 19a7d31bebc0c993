"""Readings that the limits of ``correct`` are set from, at a cell's own size.

    python3 benchmark/control.py --workload <name> --program 11,12,... --control 21,22,23

For each ``--program`` seed, the program's run as the benchmark makes it
(set-up, a one-epoch window, the reference) and its numbers. For each
``--control`` seed, the reference put in the program's place: computed in
float8 (the control), and with two faults planted (the step left
unchanged, half of the training rows left out and, at K>1, the exchange
left out), each against the float32 reference. One JSON line a reading on
standard output. The benchmark's own runs never run this.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def reference_readings(cell: dict, seeds, device: str):
    """(seed, kind, numbers) of the control and the faults on each seed."""
    import torch

    from benchmark import check, graphs, harness
    from benchmark.reference.gnn import init_params

    conf, mix = cell["configuration"], cell["mix"]
    dev = torch.device(device)
    g = graphs.make(conf, dev)
    model = conf["model"]
    ref = harness.reference(conf, g, dev)
    # one rank whose rows are the nodes in order: the reference in the
    # program's place draws its masks as the reference does
    placement = [(0, g.num_nodes, torch.arange(g.num_nodes))]
    steps = mix["checked_steps"]
    faults = [("fault_frozen", {"fault": "frozen"}), ("fault_half_batch", {"fault": "half_batch"})]
    if mix["ranks"] > 1:
        # the partition of the planted fault: equal ranges of node ids
        part = torch.arange(g.num_nodes, device=dev) * mix["ranks"] // g.num_nodes
        faults.append(("fault_no_exchange", {"fault": "no_exchange", "part": part}))
    for seed in seeds:
        p0 = init_params(seed, model["model_name"], harness.layer_dims(conf), model["use_norm"],
                         dev)
        want = check.on_cpu(ref.train(p0, seed, steps, placement))
        for kind, kw in [("control_fp8", {"precision": "fp8"})] + faults:
            got = check.on_cpu(ref.train(p0, seed, steps, placement, **kw))
            yield seed, kind, {**check.numbers(got, want),
                                  "leaves": check.leaf_deviations(got["grad1"], want["grad1"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", default="", help="comma-separated seeds of program runs")
    ap.add_argument("--control", default="", help="comma-separated seeds of reference runs")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    from benchmark.run import _caches

    _caches()
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    for seed in [int(s) for s in args.program.split(",") if s]:
        _, rec = harness.run(cell, seed, 0.0, False, args.device, time.perf_counter())
        print(json.dumps({"seed": seed, "kind": "program", **rec["numbers"],
                          "order_ok": rec["order_ok"], "losses": rec["losses"],
                          "leaves": rec["grad_leaves"],
                          "trainer_init_s": rec["trainer_init_s"]}), flush=True)
    seeds = [int(s) for s in args.control.split(",") if s]
    for seed, kind, nums in reference_readings(cell, seeds, args.device):
        print(json.dumps({"seed": seed, "kind": kind, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
