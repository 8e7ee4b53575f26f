"""The surrogate probe (kernel K9) and the probe-corrected forward LAB
(kernel K8 ``_fast``): their plain versions against the JAX package's
``_corrections`` and ``lab_forward_planes_unit_fast`` (Pallas, interpret
mode), and the probe's None contract.

The suite's XLA flags (tests/conftest.py: no FMA contraction) make
XLA:CPU round each f32 op on its own, as the port does: both then find
the cube-root surrogate off the table at indices 49, 241, 1050, 1361,
2079, 2843 and 2995.  (Optimised XLA:CPU contracts, and finds 2958 in
place of 2995.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from underwater_image_enhancement_tpu.ops import lab_tables as jlt
from underwater_image_enhancement_tpu.ops import pallas_kernels as pk
from underwater_image_enhancement_tpu_torch.ops import colorspace as tcs
from underwater_image_enhancement_tpu_torch.ops import kernels

from tests.test_torch_colorspace import _unit_planes

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["cbrt", "inv_gamma"])
def test_probe_equals_jax_corrections(name):
    assert kernels.surrogate_corrections_plain(name, CPU) == pk._corrections(name)
    assert kernels.surrogate_corrections(name, CPU) == pk._corrections(name)


def test_probe_finds_seven_cube_root_fixups_and_no_gamma_fixup():
    idx, delta = kernels.surrogate_corrections("cbrt", CPU)
    assert idx == (49, 241, 1050, 1361, 2079, 2843, 2995)
    assert delta == (-1, 1, -1, -1, -1, -1, -1)
    assert kernels.surrogate_corrections("inv_gamma", CPU) == ((), ())


@pytest.mark.parametrize("steps", [2, 3, 4])
def test_cbrt_surrogate_bit_equal_to_jax(steps):
    idx = np.arange(jlt.NCBRT, dtype=np.int32)
    want = np.asarray(jax.jit(pk._cbrt_tab_surrogate, static_argnums=1)(
        jnp.asarray(idx), steps))
    got = kernels.cbrt_tab_surrogate(torch.from_numpy(idx), steps)
    np.testing.assert_array_equal(got.numpy(), want)


def test_inv_gamma_surrogate_bit_equal_to_jax():
    idx = np.arange(jlt.INV_GAMMA_SIZE, dtype=np.int32)
    want = np.asarray(jax.jit(pk._ig_tab_surrogate)(jnp.asarray(idx)))
    got = kernels.surrogate_values("inv_gamma", CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), jlt.INV_GAMMA_TAB)


@pytest.mark.parametrize("name", ["cbrt", "inv_gamma"])
def test_corrections_make_the_surrogate_equal_its_table(name):
    corr = kernels.surrogate_corrections(name, CPU)
    idx = kernels._probe_index(name, CPU)
    fixed = kernels.apply_corrections(kernels.surrogate_values(name, CPU),
                                      idx, corr)
    table = jlt.CBRT_TAB if name == "cbrt" else jlt.INV_GAMMA_TAB
    np.testing.assert_array_equal(fixed.numpy(), table)


def test_probe_is_cached_and_launches_nothing_on_the_cpu():
    before = dict(kernels.launches)
    first = kernels.surrogate_corrections("cbrt", "cpu")
    assert kernels.surrogate_corrections("cbrt", CPU) is first
    assert kernels.launches == before


@pytest.fixture(scope="module")
def jax_fast():
    out = {}
    for seed in (0, 1):
        p = _unit_planes(seed)
        got = pk.lab_forward_planes_unit_fast(*(jnp.asarray(x) for x in p))
        out[seed] = (p, [np.asarray(x) for x in got])
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_lab_forward_fast_bit_equal_to_pallas(jax_fast, seed):
    p, want = jax_fast[seed]
    planes = [torch.from_numpy(x) for x in p]
    got = kernels.lab_forward_unit_fast_plain(*planes)
    exact = kernels.lab_forward_unit_plain(*planes)
    for g, w, e in zip(got, want, exact):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
        assert torch.equal(g, e)


@pytest.mark.parametrize("seed", [0, 1])
def test_lab_forward_fast_entry_point_on_cpu(jax_fast, seed):
    """The entry point sends CPU planes to the plain version: the same
    planes, no kernel launch counted."""
    p, want = jax_fast[seed]
    before = dict(kernels.launches)
    got = tcs.rgb_unit_to_lab_planes_fast(*(torch.from_numpy(x) for x in p))
    assert kernels.launches == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_lab_forward_fast_reads_the_table_where_the_probe_gives_up(monkeypatch):
    """More than 32 differences (the 2-step surrogate's ~370) make the
    probe return None, and the forward LAB then reads the table."""
    monkeypatch.setitem(kernels._SURROGATES, "cbrt",
                        (kernels.cbrt_tab_approx, jlt.CBRT_TAB, 0))
    monkeypatch.setattr(kernels, "_CORRECTIONS", {})
    assert kernels.surrogate_corrections("cbrt", CPU) is None
    planes = [torch.from_numpy(x) for x in _unit_planes(2)]
    for g, e in zip(kernels.lab_forward_unit_fast(*planes),
                    kernels.lab_forward_unit_plain(*planes)):
        assert torch.equal(g, e)


def test_lab_forward_fast_checks_its_planes():
    p = [torch.zeros((4, 4)) for _ in range(3)]
    p[2] = p[2].to(torch.int32)
    with pytest.raises(TypeError):
        kernels.lab_forward_unit_fast(*p)
