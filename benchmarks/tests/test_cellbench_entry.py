"""The entry point's refusals, and what the harness imports: nothing
whose top-level name is JAX's or the JAX package's."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import cpu_cells  # noqa: F401
import run

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
ARGS = ["--workload", "mixtral-chat", "--seed", str(2 ** 31 + 3),
        "--seconds", "1", "--trace", "0"]


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("ray_tpu_torch", "ray_tpu_torch.models", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ray_tpu.core", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax", "ray_tpu"]


def test_without_a_card_no_result(tmp_path):
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), *ARGS],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    p = subprocess.run([sys.executable, "benchmarks/run.py", *ARGS],
                       capture_output=True, text=True, cwd=tmp_path,
                       timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def _loaded(code: str):
    script = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
              + code + "\nimport json; print(json.dumps(sorted("
              "{m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.splitlines()[-1]))


def test_harness_and_port_import_no_jax():
    top = _loaded(
        "import run; run._environment()\n"
        "import harness.cell, harness.serve, harness.train, harness.trace\n"
        "import harness.report, calibrate, sweep\n"
        "import models.mixtral, models.llama\n"
        "import ray_tpu_torch.models.mixtral, ray_tpu_torch.models.llama\n"
        "import ray_tpu_torch.serve.llm.engine, ray_tpu_torch.train.spmd\n"
        "import ray_tpu_torch.train.optim, ray_tpu_torch.data.device_loader")
    assert not top & set(run.FORBIDDEN)
    assert "ray_tpu_torch" in top


def test_references_import_nothing_of_the_port():
    top = _loaded("import reference.mixtral, reference.llama")
    assert not top & (set(run.FORBIDDEN) | {"ray_tpu_torch"})
