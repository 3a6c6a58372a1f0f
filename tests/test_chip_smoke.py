"""chip_smoke.py off the card: it must refuse to run without a GPU, and
its result line must carry exactly the contract's keys."""

import json
import os
import subprocess
import sys

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_result_line_has_exactly_the_contract_keys():
    sys.path.insert(0, REPO)
    import chip_smoke
    devices = jax.devices()
    line = chip_smoke.result_line(devices)
    assert "\n" not in line
    out = json.loads(line)
    assert out == {"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}


def test_import_pspde_without_optional_packages():
    """import pspde needs none of flax, orbax or matplotlib (plotting
    imports matplotlib lazily)."""
    code = ("import sys\n"
            "for m in ('flax', 'flax.linen', 'orbax', 'orbax.checkpoint',"
            " 'matplotlib', 'matplotlib.pyplot'):\n"
            "    sys.modules[m] = None\n"
            "import pspde, pspde.solvers, pspde.eval, pspde.utils\n"
            "print('imported')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "imported" in r.stdout
