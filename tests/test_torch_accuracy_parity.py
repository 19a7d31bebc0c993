"""``python -m adaqp_tpu_torch.scripts.accuracy_parity`` against the
repository's ``scripts/accuracy_parity.py``: the same experiment (read from
the script's source with ``ast``, since importing it configures JAX and
its compilation cache), and a tiny run on the CPU that prints the table,
the JSON line and the adaptive run's traces."""
import ast
import json
import math
import os

import numpy as np
import pytest

from adaqp_tpu_torch.scripts import accuracy_parity as ap

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scripts", "accuracy_parity.py")


def _evaluate(node, names=None):
    return eval(compile(ast.Expression(node), SCRIPT, "eval"), {"__builtins__": {}}, names or {})


@pytest.fixture(scope="module")
def script():
    """The script's module constants, run()'s function and main()'s loop."""
    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    consts = {n.targets[0].id: _evaluate(n.value) for n in tree.body
              if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)}
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    return consts, funcs


def _script_configs(funcs):
    """The eight configurations, Vanilla's from run()'s defaults."""
    run = funcs["run"]
    defaults = dict(zip([a.arg for a in run.args.args][-len(run.args.defaults):],
                        [_evaluate(d) for d in run.args.defaults]))
    loop = next(n for n in ast.walk(funcs["main"]) if isinstance(n, ast.For))
    first = next(n for n in ast.walk(funcs["main"])
                 if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "rows")
    vanilla = (first.value.elts[0].elts[0].value, "Vanilla", defaults["scheme"],
               defaults["bits"])
    return (vanilla, *_evaluate(loop.iter))


@pytest.mark.parametrize("what", ["SYNTH", "EPOCHS", "SCALE", "configs", "overrides"])
def test_same_experiment_as_the_script(script, what):
    consts, funcs = script
    if what == "configs":
        assert ap.CONFIGS == _script_configs(funcs)
    elif what == "overrides":
        over = next(n for n in ast.walk(funcs["run"])
                    if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "over")
        want = _evaluate(over.value, {"EPOCHS": consts["EPOCHS"], "SYNTH": consts["SYNTH"],
                                      "seed": 0, "mode": "M", "scheme": "S", "bits": 3})
        _, got = ap.run_overrides("M", "S", 3, "w")
        paths = ("partition_dir", "exp_path")
        assert {k: v for k, v in got.items() if k not in (*paths, "logger_level")} == \
            {k: v for k, v in want.items() if k not in paths}
    else:
        assert getattr(ap, what) == consts[what]


def test_tiny_run_prints_every_row(tmp_path, monkeypatch, capsys):
    dump = str(tmp_path / "traces.npz")
    monkeypatch.setenv("ADAQP_DUMP_TRACES", dump)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # four ranks beside other test workers
    rows = ap.main(["--device", "cpu", "--epochs", "2", "--nodes", "300",
                    "--workdir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"accuracy_parity": rows}
    names = [name for name, *_ in ap.CONFIGS]
    assert [r["config"] for r in rows] == names
    table = lines[-1 - len(names):-1]
    for name, line, r in zip(names, table, rows):
        assert line.startswith(name) and line.split()[-2:] == [f"{r['test']:.4f}",
                                                              f"{r['delta']:+.4f}"]
        assert math.isfinite(r["test"]) and 0 <= r["test"] <= 1
        # the plain versions run on the CPU: no launch, but a plan
        assert set(r["launches"].values()) == {0} and r["planned"]["strip_spmm"] > 0
    assert rows[0]["delta"] == 0
    with np.load(dump) as z:
        layers, k = 3, 4
        assert z["tf"].shape[:3] == (layers, k, k) and z["tb"].shape[:2] == (layers, k)
        assert z["counts"].shape == (k, k) and z["tf"].any()
