"""Sharded engine on 4- and 8-device virtual CPU meshes vs the
single-device engine (bitwise in fp64)."""

import pytest

from sharded_cases import SHARDED_SCENES, check_sharded_matches_single


@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("scene", SHARDED_SCENES)
def test_sharded_matches_single(scene, D):
    check_sharded_matches_single(scene, D)
