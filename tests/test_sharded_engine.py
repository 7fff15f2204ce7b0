"""Sharded engine on 1- and 2-device virtual CPU meshes vs the
single-device engine, and the sharded factory's padding."""

import numpy as np
import pytest

from pffdtd_jax.parallel.sharded_engine import (ShardedEngine, make_mesh,
                                                make_sharded_engine)
from pffdtd_jax.prep import pad_x

import scenes
from sharded_cases import SHARDED_SCENES, check_sharded_matches_single


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("scene", SHARDED_SCENES)
def test_sharded_matches_single(scene, D):
    check_sharded_matches_single(scene, D)


@pytest.mark.parametrize("Nx,D,want", [(16, 2, 16), (17, 2, 18),
                                       (17, 8, 32), (33, 8, 40),
                                       (16, 4, 16), (13, 1, 13)])
def test_pad_x(Nx, D, want):
    sim = scenes.make("odd_nx")
    from dataclasses import replace

    vox = replace(sim.vox, Nx=Nx, xv=sim.vox.xv[:1] + sim.vox.h
                  * np.arange(Nx))
    out = pad_x(replace(sim, vox=vox), D, min_rows=4)
    assert out.vox.Nx == want and out.vox.xv.size == want
    assert out.vox.Nx % D == 0 and out.vox.Nx // D >= 4
    # padding appends rows past the high-x end: existing indices keep
    # their meaning, since z and y strides do not change
    assert np.array_equal(out.vox.xv[:Nx], vox.xv)
    assert np.allclose(np.diff(out.vox.xv), sim.vox.h)


def test_make_sharded_engine_pads_and_routes():
    sim = scenes.make("odd_nx")
    assert sim.vox.Nx % 2
    eng = make_sharded_engine(consts=sim.consts, vox=sim.vox,
                              comms=sim.comms, mats=sim.mats,
                              mesh=make_mesh(2), dtype=np.float64)
    assert isinstance(eng, ShardedEngine)
    assert eng.data.grid.Nx == sim.vox.Nx + 1 and eng.S >= 4
    u = eng.run(verbose=False)
    assert np.isfinite(u).all() and np.abs(u).max() > 0


def test_sharded_engine_rejects_indivisible_grid():
    sim = scenes.make("odd_nx")
    with pytest.raises(ValueError, match="not divisible"):
        ShardedEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                      mats=sim.mats, mesh=make_mesh(2), dtype=np.float64)
