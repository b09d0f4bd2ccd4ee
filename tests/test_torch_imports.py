"""Import hygiene and device rules of the PyTorch port."""

import os
import re
import subprocess
import sys

import pytest
import torch

import tt_irt_tpu_torch as tp
from tt_irt_tpu_torch.ops.dim_step import dim_step_cuda
from tt_irt_tpu_torch.ops.fused_irt import fused_irt_sqr_cuda
from tt_irt_tpu_torch.ops.odim_step import odim_step_cuda
from tt_irt_tpu_torch.ops.step import (cdf_bracket_factor_cuda,
                                       condition_update_cuda,
                                       factor_conditional_cuda,
                                       gram_conditional_cuda)
from tt_irt_tpu_torch.utils.device import resolve_device

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DATA = os.path.join(ROOT, "examples", "data")


def test_port_and_chip_smoke_import_no_jax():
    """A fresh interpreter imports every module of the port and
    chip_smoke (without running it); none pulls in jax, the JAX package
    or bench.py."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import pkgutil, importlib, tt_irt_tpu_torch\n"
        "for m in pkgutil.walk_packages(tt_irt_tpu_torch.__path__,"
        " 'tt_irt_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for need in ('ops.step', 'ops.fused_irt', 'ops.rowmath',"
        " 'ops.odim_step', 'ops.kernel_plan', 'samplers.irt_scan',"
        " 'samplers.irt', 'ops.tt', 'samplers.dirt', 'samplers.serve',"
        " 'samplers.debias', 'samplers.diagnostics', 'models.ode',"
        " 'models.lorenz', 'utils.checkpoint', 'ops.maxvol', 'ops.interp',"
        " 'constructors.amen_cross', 'constructors.greedy_cross',"
        " 'constructors.dirt_build', 'samplers.qmc',"
        " 'models.shock_absorber', 'models.predator_prey',"
        " 'samplers.fourier', 'samplers.chebyshev', 'samplers.dirt_scan',"
        " 'constructors.als_cross', 'models.diffusion',"
        " 'samplers.conditional', 'api', 'constructors.finetune',"
        " 'samplers.dram', 'samplers.svn', 'parallel.mesh', 'native',"
        " 'ops.tracemult', 'utils.profiling', 'utils.verify_env',"
        " 'utils.reference_numpy'):\n"
        "    assert 'tt_irt_tpu_torch.' + need in sys.modules, need\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tt_irt_tpu' or m.startswith('tt_irt_tpu.')"
        " or m == 'bench']\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_card_only_files_name_no_jax():
    """chip_smoke.py, the card tests, the card tools and every module of
    the port hold no import of jax, the JAX package or bench.py."""
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tests", "test_torch_cuda.py")]
    for sub in ("tt_irt_tpu_torch", "tools"):
        for base, _, names in os.walk(os.path.join(ROOT, sub)):
            files += [os.path.join(base, n) for n in names
                      if n.endswith(".py")]
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|tt_irt_tpu|bench)\b(?!_)",
                     re.M)
    for path in files:
        with open(path) as fh:
            hits = pat.findall(fh.read())
        assert not hits, (path, hits)


def _small_tt():
    cores = [torch.rand((1, 9, 2), dtype=torch.float64) + 0.1,
             torch.rand((2, 9, 1), dtype=torch.float64) + 0.1]
    return (tp.TT(cores), [torch.linspace(-1, 1, 9, dtype=torch.float64)] * 2,
            torch.rand((8, 2), dtype=torch.float64))


@pytest.mark.parametrize("entry", ["tt_irt_sqr", "tt_rt_sqr", "irt_scan",
                                   "fused_irt_sqr", "IrtSampler"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Each entry point of the Gram slice runs on the card by default:
    without one it raises (no CPU fallback), and device='cpu' runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tt, grids, q = _small_tt()
    if entry == "irt_scan":
        # operand-level: runs where its tensors lie; CPU tensors use the
        # plain versions and count no launch
        from tt_irt_tpu_torch.samplers.irt_scan import stack_padded
        cs, xs = stack_padded(tt, grids)
        x, lf = tp.irt_scan("sqr", cs, xs, q, 1024, "f32")
        assert x.shape == (8, 2)
        assert gram_conditional_cuda.launches == 0
        return
    fn = getattr(tp, entry)
    call = (lambda **kw: fn(grids, tt, **kw)(q)) if entry == "IrtSampler" \
        else (lambda **kw: fn(grids, tt, q, **kw))
    with pytest.raises(RuntimeError, match="not available"):
        call()
    x, lf = call(device="cpu")
    assert x.shape == (8, 2) and bool(torch.isfinite(lf).all())


def _small_dirt():
    tt, grids, q = _small_tt()
    return tp.DIRT(tt, [tt], grids, grids, torch.tensor([0.5, 1.0])), q


@pytest.mark.parametrize("entry", ["tt_irt_lin", "IrtSampler_lin",
                                   "tt_dirt_sample", "tt_dirt_inverse",
                                   "tt_irt_debias"])
def test_slice_four_entry_points_default_to_the_card(entry, monkeypatch):
    """The entry points of the functional DIRT API, mode 'lin' and the
    debias entry point run on the card by default: without one they raise
    (no CPU fallback), and device='cpu' runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tt, grids, q = _small_tt()
    dirt, _ = _small_dirt()
    call = {
        "tt_irt_lin": lambda **kw: tp.tt_irt_lin(grids, tt, q, **kw),
        "IrtSampler_lin": lambda **kw: tp.IrtSampler(grids, tt, "lin",
                                                     **kw)(q),
        "tt_dirt_sample": lambda **kw: tp.tt_dirt_sample(dirt, q, **kw),
        "tt_dirt_inverse": lambda **kw: tp.tt_dirt_inverse(dirt, q * 0.5,
                                                           **kw),
        "tt_irt_debias": lambda **kw: tuple(tp.tt_irt_debias(
            q, lambda y: -0.5 * (y ** 2).sum(1), tt, grids, "iw",
            **kw)[k] for k in ("y", "lFapp")),
    }[entry]
    with pytest.raises(RuntimeError, match="not available"):
        call()
    x, lf = call(device="cpu")
    assert x.shape == (8, 2) and bool(torch.isfinite(lf).all())


@pytest.mark.parametrize("precision,hi_step", [
    ("hi", "odim"), ("hi", "bracket"), ("hi", "pair"), ("hid", "dim"),
    ("gs", "dim"), ("ds", "dim")])
def test_new_variants_default_to_the_card(precision, hi_step, monkeypatch):
    """Every hi_step and every precision of the factor family runs on the
    card by default, through tt_irt_sqr and DirtSampler alike: without a
    card it raises (no CPU fallback), device='cpu' runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tt, grids, q = _small_tt()
    with pytest.raises(RuntimeError, match="not available"):
        tp.tt_irt_sqr(grids, tt, q, precision=precision, hi_step=hi_step)
    x, lf = tp.tt_irt_sqr(grids, tt, q, precision=precision,
                          hi_step=hi_step, device="cpu")
    assert x.shape == (8, 2) and bool(torch.isfinite(lf).all())
    stack = tp.load_dirt(os.path.join(DATA, "lz10_ck"), device="cpu")
    with pytest.raises(RuntimeError, match="not available"):
        tp.DirtSampler(stack, precision=precision, hi_step=hi_step)


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="not available"):
        tp.load_dirt(os.path.join(DATA, "lz10_ck"))
    stack = tp.load_dirt(os.path.join(DATA, "lz10_ck"), device="cpu")
    with pytest.raises(RuntimeError, match="not available"):
        tp.DirtSampler(stack, precision="hi")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_serve_launches_no_kernel():
    """On the CPU every serve path (each precision family and each
    hi_step) runs the plain versions: the launch counters stay 0."""
    stack = tp.load_dirt(os.path.join(DATA, "lz10_ck"), device="cpu")
    g = torch.Generator().manual_seed(0)
    q = tp.randref(stack.reference, g, (64, stack.d))
    for precision, hi_step in (("hi", "dim"), ("f32", "dim"), ("hi", "odim"),
                               ("hi", "bracket"), ("hi", "pair"),
                               ("hid", "dim"), ("gs", "dim"), ("ds", "dim")):
        z, lf = tp.DirtSampler(stack, precision=precision, device="cpu",
                               hi_step=hi_step)(q)
        assert z.shape == (64, stack.d) and bool(torch.isfinite(lf).all())
    for fn in (dim_step_cuda, odim_step_cuda, cdf_bracket_factor_cuda,
               factor_conditional_cuda, gram_conditional_cuda,
               condition_update_cuda, fused_irt_sqr_cuda):
        assert fn.launches == 0, fn.__name__


@pytest.mark.parametrize("entry", ["amen_cross_s", "greedy_cross",
                                   "tt_dirt_approx"])
def test_slice_five_entry_points_default_to_the_card(entry, monkeypatch):
    """The constructors build on the card by default: without one they
    raise (no CPU fallback), and device='cpu' builds there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grids = [torch.linspace(-1.0, 1.0, 7, dtype=torch.float64)] * 3

    def index_fun(ind):
        return torch.exp(-sum(grids[k][ind[:, k]] ** 2 for k in range(3)))

    call = {
        "amen_cross_s": lambda **kw: tp.amen_cross_s(
            [7] * 3, index_fun, 1e-8, nswp=2, **kw).tt,
        "greedy_cross": lambda **kw: tp.greedy_cross(
            [7] * 3, index_fun, 1e-8, nswp=2, **kw).tt,
        "tt_dirt_approx": lambda **kw: tp.tt_dirt_approx(
            grids, lambda x, b0, b1: -0.5 * (b1 - b0) * (x * x).sum(1),
            [0.5, 1.0], nswp=1, kickrank=0, testsamples=16, **kw).f0,
    }[entry]
    with pytest.raises(RuntimeError, match="not available"):
        call()
    tt = call(device="cpu")
    assert tt.device.type == "cpu" and tt.d == 3


@pytest.mark.parametrize("entry", ["tt_irt_cond", "tt_dirt_cond_sample",
                                   "sample_posterior", "dirt_finetune",
                                   "dram", "svn"])
def test_slice_seven_entry_points_default_to_the_card(entry, monkeypatch):
    """Conditional sampling, the one-call front end, fine-tuning and the
    two baselines run on the card by default: without one they raise (no
    CPU fallback), and device='cpu' runs."""
    from tt_irt_tpu_torch.samplers.dram import dram
    from tt_irt_tpu_torch.samplers.svn import svn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tt, grids, q = _small_tt()
    dirt, _ = _small_dirt()

    def lp(x):
        return -0.5 * torch.sum(x * x, dim=-1)

    call = {
        "tt_irt_cond": lambda **kw: tp.tt_irt_cond(
            grids, tt, [0.1], q[:, 1:], **kw),
        "tt_dirt_cond_sample": lambda **kw: tp.tt_dirt_cond_sample(
            dirt, [0.1], q[:, 1:], **kw),
        "sample_posterior": lambda **kw: tp.sample_posterior(
            lp, [g.numpy() for g in grids], 8, **kw),
        "dirt_finetune": lambda **kw: tp.dirt_finetune(
            dirt, lp, steps=1, nsamples=8, **kw),
        "dram": lambda **kw: dram(lp, q, 3, **kw),
        "svn": lambda **kw: svn(lambda x: -lp(x), q, steps=1, **kw),
    }[entry]
    with pytest.raises(RuntimeError, match="not available"):
        call()
    assert call(device="cpu") is not None


def test_cap_refusals_name_what_serves_the_shape():
    """A kernel's refusal past its caps names what serves the shape on
    the card: past the wide tiers (n, r <= 128) of every kernel, the
    factor family and the whole-transform kernel included, 'f64'."""
    from tt_irt_tpu_torch.ops import rowmath
    from tt_irt_tpu_torch.ops.rowmath import SERVED_ANY, check_factor_caps

    with pytest.raises(ValueError, match=r"caps n<=128, r<=128.*'f64'"):
        check_factor_caps("dim_step_cuda", 9, 129, 128, 128, 0)
    with pytest.raises(ValueError, match=r"caps n<=128, r<=128.*'f64'"):
        check_factor_caps("gram_conditional_cuda", 129, 4, 128, 128, 0,
                          SERVED_ANY)
    assert "f32" not in SERVED_ANY
    assert not hasattr(rowmath, "SERVED_WIDER")
    check_factor_caps("dim_step_cuda", 96, 128, 128, 128, 202752)
