"""Port parity: the attention probes' kernels
(``seed_story_torch.benchmarks.probe_kernels``) against the six Pallas
kernels of ``benchmarks/probe_attn_variants.py``, ``probe_attn_overhead.py``
and ``probe_attn_dma.py``.

The JAX probes take no ``interpret`` argument and ``benchmarks/`` has no
package, so each probe file is loaded from its path and, in every test,
``jax.experimental.pallas.pallas_call`` is patched to run in interpret mode
(the probes look it up when ``jax.jit`` traces). Loading a probe sets JAX's
compilation cache directory and puts the repo on ``sys.path``; both are
restored right after the load. The port's functions run their plain
versions (CPU tensors). Inputs come from ``numpy.random.default_rng`` in f32.

Tolerances: 1e-5 max abs for ``base``, ``exp2`` and the single pass; the
copies bitwise. ``noexp`` returns O = acc / l with l = sum_j scale * S_ij,
whose sign is random, so l comes near 0 on some rows and O there is as
large as the cancellation makes it. It is held by the conditioned measure
of ``probe_kernels.noexp_error``: for every element, |O - O_ref| * |l| <=
tol * (max |O_ref * l| + |O_ref| * sum_j |scale * S_ij|), l and the sum of
magnitudes computed from the inputs in f64. The first term bounds the error
of the numerator acc, the second that of a denominator summed from terms
of that size in another order; without the second, the f32 rounding of l
alone (~1e-7 of sum |scale * S|) exceeds 1e-5 of max |acc| on the row where
l cancels most. The measure is taken over every row of seeded inputs.
"""

import functools
import importlib.util
import pathlib
import sys

import jax
import jax.experimental.pallas
import numpy as np
import pytest
import torch

from seed_story_torch.benchmarks import probe_kernels as port

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5
SHAPES = [(1, 2, 256, 64), (2, 2, 128, 64)]
BLOCKS = [(128, 64), (64, 128)]
ENTRY_POINTS = ("probe_attn_variants", "probe_attn_overhead", "probe_attn_dma")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, so that parallel test workers do not
    oversubscribe the cores they share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_probes():
    """The three JAX probe modules, loaded from their files with JAX's
    compilation cache setting and ``sys.path`` restored afterwards."""
    cache_dir = jax.config.jax_compilation_cache_dir
    path = list(sys.path)
    mods = {}
    try:
        for name in ("probe_attn_variants", "probe_attn_overhead", "probe_attn_dma"):
            spec = importlib.util.spec_from_file_location(
                f"_jax_{name}", REPO / "benchmarks" / f"{name}.py")
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        sys.path[:] = path
    return mods


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    original = jax.experimental.pallas.pallas_call
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        functools.partial(original, interpret=True))


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32) for _ in range(3))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("block_q,block_kv", BLOCKS)
@pytest.mark.parametrize("variant", port.VARIANTS)
def test_attn_variant_matches_jax(jax_probes, variant, block_q, block_kv, shape):
    q, k, v = _inputs(shape)
    want = np.asarray(jax_probes["probe_attn_variants"].attn(q, k, v, variant, block_q, block_kv))
    before = port.probe_attn.launches
    got = port.attn(*map(torch.from_numpy, (q, k, v)), variant, block_q, block_kv).numpy()
    assert port.probe_attn.launches == before  # CPU tensors take the plain version
    assert got.shape == want.shape and got.dtype == np.float32
    if variant == "noexp":
        assert port.noexp_error(*map(torch.tensor, (q, k, got, want))) <= TOL
    else:
        assert float(np.abs(got - want).max()) <= TOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("probe", ["probe_attn_overhead", "probe_attn_dma"])
def test_copy_only_matches_jax_bitwise(jax_probes, probe, shape):
    q, k, v = _inputs(shape, seed=1)
    want = np.asarray(jax_probes[probe].copy_only(q, k, v))
    got = port.copy_only(*map(torch.from_numpy, (q, k, v))).numpy()
    assert np.array_equal(got, want)


SINGLE_PASS = {"single_pass": "probe_attn_overhead",
               "single_pass_fused_bh": "probe_attn_overhead",
               "attn_packed2": "probe_attn_dma"}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(SINGLE_PASS))
def test_single_pass_family_matches_jax(jax_probes, name, shape):
    q, k, v = _inputs(shape, seed=2)
    want = np.asarray(getattr(jax_probes[SINGLE_PASS[name]], name)(q, k, v))
    got = getattr(port, name)(*map(torch.from_numpy, (q, k, v))).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL


def test_packing_is_the_jax_layout():
    """Head 2i of a pair fills columns :64 of the packed row, head 2i + 1
    columns 64:, and unpacking inverts it."""
    x = torch.arange(2 * 4 * 3 * 64, dtype=torch.float32).reshape(2, 4, 3, 64)
    packed = port.pack_pairs(x)
    assert packed.shape == (2, 2, 3, 128)
    assert torch.equal(packed[:, 1, :, :64], x[:, 2]) and torch.equal(packed[:, 1, :, 64:], x[:, 3])
    assert torch.equal(port.unpack_pairs(packed), x)


KERNEL_CALLS = {
    "attn": lambda q, k, v: port.attn(q, k, v, implementation="kernel"),
    "copy_only": lambda q, k, v: port.copy_only(q, k, v, implementation="kernel"),
    "single_pass": lambda q, k, v: port.single_pass(q, k, v, implementation="kernel"),
    "single_pass_fused_bh": lambda q, k, v: port.single_pass_fused_bh(
        q, k, v, implementation="kernel"),
    "attn_packed2": lambda q, k, v: port.attn_packed2(q, k, v, implementation="kernel"),
}


@pytest.mark.parametrize("name", list(KERNEL_CALLS))
def test_kernel_request_on_cpu_tensors_raises(name):
    q, k, v = (torch.zeros(1, 2, 128, 64, dtype=torch.bfloat16) for _ in range(3))
    launches = {kernel.name: kernel.launches for kernel in port.KERNELS}
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        KERNEL_CALLS[name](q, k, v)
    assert {kernel.name: kernel.launches for kernel in port.KERNELS} == launches


@pytest.mark.parametrize("blocks", [(1024, 1024), (512, 1024), (512, 512), (256, 1024),
                                    (32, 64)])
def test_block_without_an_instance_raises(blocks):
    """The TPU probe's blocks (and any other size) have no instance on the
    card; the refusal holds for the plain version too, so that both sweep
    the same tiles."""
    q, k, v = (torch.zeros(1, 1, 1024, 64) for _ in range(3))
    with pytest.raises(ValueError, match="no instance"):
        port.attn(q, k, v, "base", *blocks)


@pytest.mark.parametrize("name,shape", [("single_pass_fused_bh", (1, 3, 64, 64)),
                                        ("attn_packed2", (2, 3, 64, 64))])
def test_odd_head_counts_raise(name, shape):
    q, k, v = (torch.zeros(shape) for _ in range(3))
    with pytest.raises(ValueError, match="even"):
        getattr(port, name)(q, k, v)


def test_bad_arguments_raise():
    q, k, v = (torch.zeros(1, 1, 192, 64) for _ in range(3))
    with pytest.raises(ValueError, match="multiple"):
        port.attn(q, k, v, "base", 128, 128)
    with pytest.raises(ValueError, match="unknown variant"):
        port.attn(q, k, v, "exp10")
    with pytest.raises(ValueError, match="unknown implementation"):
        port.copy_only(q, k, v, implementation="xla")
    with pytest.raises(ValueError, match="one"):
        port.single_pass(q, k[..., :32], v)


@pytest.mark.parametrize("probe", ENTRY_POINTS)
def test_entry_point_raises_without_a_card(probe, monkeypatch):
    module = importlib.import_module(f"seed_story_torch.benchmarks.{probe}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        module.main()


@pytest.mark.parametrize("probe", ENTRY_POINTS)
def test_entry_point_runs_the_plain_versions_on_the_cpu(probe, capsys):
    module = importlib.import_module(f"seed_story_torch.benchmarks.{probe}")
    shape = (1, 2, 128, 64)
    kw = dict(shape=shape) if probe == "probe_attn_dma" else dict(shapes=[shape])
    launches = {kernel.name: kernel.launches for kernel in port.KERNELS}
    rows = module.main(device="cpu", n=1, **kw)
    assert {kernel.name: kernel.launches for kernel in port.KERNELS} == launches
    assert "host clock" in capsys.readouterr().out
    diffs = [r["max_abs"] for r in rows if "max_abs" in r]
    assert diffs and all(d <= 2e-2 for d in diffs)  # bf16 outputs against the plain mha
    assert all(np.isfinite(r["ms"]) for r in rows if "ms" in r)
