"""The port's frontend against the JAX package's on rendered frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvo_rgbd_torch import synth as tsynth
from cvo_rgbd_torch.frontend import image as timage
from cvo_rgbd_torch.frontend import make_frontend as t_make_frontend
from cvo_rgbd_torch.frontend import selector as tselector
from cvo_rgbd_tpu import synth as jsynth
from cvo_rgbd_tpu.frontend import image as jimage
from cvo_rgbd_tpu.frontend import make_frontend as j_make_frontend
from cvo_rgbd_tpu.frontend import selector as jselector

torch.set_num_threads(2)

H, W = 96, 128


@pytest.fixture(scope="module")
def frames():
    """Three frames of the revisit path, quantized as the PNGs store them."""
    return list(tsynth.render_frames(tsynth.revisit_path(3, period=33),
                                     tsynth.BandScene(h=H, w=W)))


def test_render_matches_jax_synth(frames):
    scene = jsynth.BandScene(h=H, w=W)
    path = jsynth.revisit_path(3, period=33)
    for i, name, rgb, dep, pose in frames:
        R, c = scene.pose(path, i)
        ref_rgb, ref_dep = scene.render(R, c)
        np.testing.assert_array_equal(rgb, ref_rgb.astype(np.uint8))
        np.testing.assert_array_equal(
            dep, (ref_dep * scene.cam.scaling_factor).astype(np.uint16))
        np.testing.assert_array_equal(pose[:3, :3], R)
        assert name == f"{200.0 + 0.1 * i:.6f}"


def test_pyramid_and_selection_match_jax(frames):
    for _, _, rgb, _, _ in frames:
        gray = np.asarray(jax.jit(jimage.rgb_to_gray)(rgb))
        np.testing.assert_array_equal(
            timage.rgb_to_gray(torch.from_numpy(rgb)).numpy(), gray)
        jpyr = jax.jit(jimage.make_pyramid)(gray)
        tpyr = timage.make_pyramid(torch.from_numpy(gray.copy()))
        for jl, tl in zip(jpyr, tpyr):
            for a, b in zip(jl, tl):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        jidx, jvalid = jax.jit(lambda p: jselector.select_pixels(p, 1024))(jpyr)
        tidx, tvalid = tselector.select_pixels(tpyr, 1024)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("feature_type", [1, 0])
def test_clouds_match_jax(frames, feature_type):
    jf = j_make_frontend(1, 1024, feature_type)
    tf = t_make_frontend(1, 1024, feature_type, device="cpu")
    for _, _, rgb, dep, _ in frames:
        ref = jf(jnp.asarray(rgb), jnp.asarray(dep))
        got = tf(rgb, dep)
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
        assert got.mask.sum() > 300
        # backprojection (x - cx) * z / fx rounds differently under XLA's
        # fusion: 1e-5 relative
        np.testing.assert_allclose(got.positions.numpy(),
                                   np.asarray(ref.positions),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.features.numpy(),
                                   np.asarray(ref.features),
                                   rtol=1e-5, atol=1e-6)
