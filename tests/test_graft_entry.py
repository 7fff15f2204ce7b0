"""The entry points in __graft_entry__: the one-step compile check and the
multi-device dry run on a virtual CPU mesh."""

import numpy as np
import pytest

import jax

import __graft_entry__ as ge


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_dryrun_multichip(n_devices):
    ge.dryrun_multichip(n_devices)


def test_entry_step_compiles_and_steps():
    fn, (carry, sig, C) = ge.entry()
    carry2, out = jax.jit(fn)(carry, sig, C)
    assert out.shape == (ge._demo_sim().comms.out_ixyz.size,)
    assert all(np.isfinite(np.asarray(c)).all()
               for c in jax.tree.leaves(carry2))
