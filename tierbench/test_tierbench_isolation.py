"""What the benchmark loads: no JAX and no JAX package in what ``run.py``
runs, nothing of the program in the plain references, and no result
without a card."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "tierbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _loaded(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    ``code``, compared whole."""
    src = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n{code}\n"
           "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                         cwd=ROOT, timeout=240, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax_nor_the_jax_package():
    code = """
import copy, glob, importlib, os
import tierbench.run, tierbench.control, tierbench.sweep
from tierbench import harness
for f in sorted(glob.glob(os.path.join(harness.HERE, 'metrics', '*.py'))):
    importlib.import_module('tierbench.metrics.' + os.path.basename(f)[:-3])
cell = harness.load_cell('qwen1_5_4b-longctx')
conf = copy.deepcopy(cell.conf)
conf.update(hidden_size=64, intermediate_size=160, num_attention_heads=4,
            num_key_value_heads=4, num_hidden_layers=2, vocab_size=256, head_dim=16)
params = harness.weights.make(conf, 1, 'cpu')
eng = harness.build_engine(conf, dict(batch_slots=2, max_seq_len=128), params, 'cpu')
eng.start_request(0, eng.make_request([1, 2, 3] * 20, 4))
eng.step()
"""
    loaded = _loaded(code)
    assert "repro_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_references_import_nothing_of_the_program():
    refs = sorted((HERE / "references").glob("*.py"))
    assert any(p.name == "dense_decoder.py" for p in refs)
    for p in refs:
        assert not _imports(p) & (FORBIDDEN | {"repro_torch", "tierbench"}), p
    loaded = _loaded("import tierbench.references.dense_decoder")
    assert not loaded & (FORBIDDEN | {"repro_torch"})


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "tierbench/run.py", "--workload", "qwen1_5_4b-longctx",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=240)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
