"""Nothing under benchmark/ imports JAX or the JAX package (by whole
top-level name: the port's name begins with the JAX package's), and the
reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FOREIGN = {"jax", "jaxlib", "flax", "ofb_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_of_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FOREIGN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "ofb_tpu_torch" not in set(_imports(path))


def test_the_harness_and_the_program_it_drives_load_no_jax():
    import subprocess
    import sys
    code = ("import benchmark.run as R, benchmark.control, "
            "benchmark.phases.search, benchmark.phases.finetune, "
            "ofb_tpu_torch.core.steps, ofb_tpu_torch.models.registry, "
            "ofb_tpu_torch.core.lr_decay; print(R.foreign_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _rank_whose_reference_loads_jax(rank, port, stub, q):
    import importlib
    import json
    import sys

    import torch
    from benchmark import run as R
    from benchmark.reference import steps as ref_steps
    from tiny import TinyCell
    torch.set_num_threads(1)
    sys.path.insert(0, stub)
    run = ref_steps.run

    def run_loading_jax(*a, **k):
        importlib.import_module("jax")                  # the stub
        return run(*a, **k)

    ref_steps.run = run_loading_jax
    out = R.run_rank(TinyCell("search", chips=2, A=1), 23, 0.2, False,
                     rank=rank, world=2, device="cpu", port=port)
    q.put((rank, json.dumps(out)))


def test_jax_loaded_by_a_ranks_reference_ends_the_run_without_a_line(
        tmp_path, monkeypatch, capsys):
    import json

    import torch.multiprocessing as mp
    from benchmark import run as R
    from tiny import TinyCell
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = R._free_port()
    procs = [ctx.Process(target=_rank_whose_reference_loads_jax,
                         args=(r, port, str(tmp_path), q)) for r in range(2)]
    for p in procs:
        p.start()
    got = dict(q.get(timeout=600) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    outs = [json.loads(got[r]) for r in range(2)]
    assert outs[0]["foreign"] == ["jax"] and outs[1]["foreign"] == []
    line = R.merge(TinyCell("search", chips=2, A=1), outs, False)
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        R.emit(line, outs)
    assert e.value.code == 1
    assert capsys.readouterr().out == ""
