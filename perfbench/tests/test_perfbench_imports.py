"""No run loads JAX, jaxlib, flax or the JAX package (top-level names
compared whole: the port's own name begins with the JAX package's), and
the plain reference loads nothing of the program."""

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "conan_fgw_tpu"}


def modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax(tmp_path):
    from conftest import write_tiny_root

    root = write_tiny_root(tmp_path, molecules=16)
    top = modules_after(
        "import sys; sys.path.insert(0, 'perfbench/tests'); sys.path.insert(0, '.')\n"
        "import torch; torch.set_num_threads(2)\n"
        "from pathlib import Path\nfrom conftest import tiny_run\n"
        f"result, _ = tiny_run(Path({str(root)!r}))\nassert result['checks']\n"
        "from perfbench import run\nassert run.forbidden_modules() == []\n")
    assert not top & FORBIDDEN
    assert "conan_fgw_tpu_torch" in top and "perfbench" in top


def test_the_reference_loads_nothing_of_the_program():
    top = modules_after("import sys; sys.path.insert(0, '.')\n"
                        "from perfbench.references import conan_schnet\n"
                        "from perfbench import traffic, peaks\n")
    assert not top & (FORBIDDEN | {"conan_fgw_tpu_torch"})


def test_the_forbidden_check_compares_whole_names():
    sys.path.insert(0, str(ROOT / "perfbench"))
    import run

    sys.modules.setdefault("conan_fgw_tpu_torch_like", sys)
    assert "conan_fgw_tpu_torch" not in run.forbidden_modules()
    sys.modules["jaxlib_fake.sub"] = sys
    try:
        assert run.forbidden_modules() == []
        sys.modules["jax.fake"] = sys
        assert run.forbidden_modules() == ["jax.fake"]
    finally:
        sys.modules.pop("jax.fake", None)
        sys.modules.pop("jaxlib_fake.sub", None)
        sys.modules.pop("conan_fgw_tpu_torch_like", None)
