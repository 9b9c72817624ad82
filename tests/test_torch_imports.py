"""The port stands alone: neither ``pyabc_tpu_torch`` nor ``chip_smoke.py``
imports JAX or the JAX package, and the port never runs on the CPU unless
asked to."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)

_PROBE = r'''
import importlib, importlib.abc, json, pkgutil, sys

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if (name == "jax" or name.startswith("jax.")
                or name == "jaxlib" or name.startswith("jaxlib.")
                or name == "pyabc_tpu" or name.startswith("pyabc_tpu.")):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
import torch
torch.set_num_threads(1)
import pyabc_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    pyabc_tpu_torch.__path__, "pyabc_tpu_torch."))
for m in mods:
    importlib.import_module(m)
import chip_smoke

torch.cuda.is_available = lambda: False
from pyabc_tpu_torch import ABCSMC
from pyabc_tpu_torch.models import gaussian
try:
    ABCSMC(gaussian.make_mean_only_model(), gaussian.mean_only_prior())
    raised = None
except RuntimeError as exc:
    raised = str(exc)
cpu = ABCSMC(gaussian.make_mean_only_model(), gaussian.mean_only_prior(),
             device="cpu")
from pyabc_tpu_torch import convert
convert_raised = []
for fn, arg in [(convert.distance_weights, [1.0, 2.0]),
                (convert.transition_params, {}), (convert.carry, ())]:
    try:
        fn(arg)
    except RuntimeError as exc:
        convert_raised.append("device='cpu'" in str(exc))
print(json.dumps({
    "modules": mods,
    "loaded": sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "pyabc_tpu")),
    "raised": raised, "cpu_device": str(cpu.device),
    "convert_raised": convert_raised,
    "chip_smoke_rc": chip_smoke.main(),
}))
'''


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    # the blocker matches "pyabc_tpu" and "pyabc_tpu.*" only, so the port
    # itself (pyabc_tpu_torch) imports; every submodule was imported
    assert "pyabc_tpu_torch.inference.smc" in res["modules"]
    assert "pyabc_tpu_torch.kernels._build" in res["modules"]
    # the noisy-ABC slice's modules keep their own copies of what they
    # need of the JAX package (pdf norms, temperature schemes, SIR)
    assert {"pyabc_tpu_torch.acceptor.pdf_norm",
            "pyabc_tpu_torch.distance.kernel",
            "pyabc_tpu_torch.epsilon.temperature",
            "pyabc_tpu_torch.kernels.kernel_accept",
            "pyabc_tpu_torch.kernels.sir_simulate",
            "pyabc_tpu_torch.kernels.temperature_update",
            "pyabc_tpu_torch.models.sir"} <= set(res["modules"])
    # so do the model-selection slice's (the perturbation kernel, the ODE
    # family, K20b and K26)
    assert {"pyabc_tpu_torch.transition.model_perturbation",
            "pyabc_tpu_torch.models.model_selection",
            "pyabc_tpu_torch.kernels.ode_family",
            "pyabc_tpu_torch.kernels.model_step"} <= set(res["modules"])
    # and the tau-leap / early-reject slice's (K18, K19, K20b network)
    assert {"pyabc_tpu_torch.ops.segment",
            "pyabc_tpu_torch.models.gillespie",
            "pyabc_tpu_torch.kernels.tau_leap",
            "pyabc_tpu_torch.kernels.network_sir",
            "pyabc_tpu_torch.kernels.segment_round"} <= set(res["modules"])
    # and LocalTransition's (K12-K15, the selection ops)
    assert {"pyabc_tpu_torch.ops.select",
            "pyabc_tpu_torch.transition.local_transition",
            "pyabc_tpu_torch.kernels.local_cov",
            "pyabc_tpu_torch.kernels.local_factor",
            "pyabc_tpu_torch.kernels.local_logpdf",
            "pyabc_tpu_torch.kernels.proposal_drift"} <= set(res["modules"])
    # and adaptive / K > 1 early reject's (K22, its plain moment blocks;
    # the segmented family's range kernel lives in kernels.ode_family)
    assert {"pyabc_tpu_torch.ops.scale_reduce",
            "pyabc_tpu_torch.kernels.moments"} <= set(res["modules"])
    assert res["loaded"] == []
    # without CUDA the default device raises and names the way out
    assert res["raised"] is not None and "device='cpu'" in res["raised"]
    assert res["cpu_device"] == "cpu"
    # so do the converters that carry JAX state across
    assert res["convert_raised"] == [True, True, True]
    # chip_smoke.py refuses to run without a card
    assert res["chip_smoke_rc"] != 0


def test_no_import_lines_name_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|pyabc_tpu)(\.|\s|$)")
    files = [*sorted((REPO / "pyabc_tpu_torch").rglob("*.py")),
             REPO / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert len(files) > 20 and hits == []


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script exits nonzero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
