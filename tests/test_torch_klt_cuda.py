"""The pyramidal KLT's CUDA kernel (``csrc/klt_track.cu``) and its wrapper
``ops/klt.track_pyramid``.

On the CPU: CPU tensors go through the plain version and launch nothing;
the plain version stays the JAX package's ``track_pyramid`` (the
tolerances of ``test_torch_frontend.py``: positions 1e-2 px, status on 97%
of slots); the wrapper raises on a wrong dtype, a wrong shape or mixed
devices.

On the card (marker ``card``; run there with ``python3 -m pytest
tests/test_torch_klt_cuda.py -m card --noconftest``, since
``tests/conftest.py`` sets up JAX): the kernel against the plain version on
the card, at 376x1241 on a rendered street, B = 4 frame pairs and 512 GFTT
features a frame, for each leg with zero, stereo and flow-prior inits, an
unbatched (H, W) call, features within the KLT margin of the border and
features in a flat patch that fail the eigenvalue gate. Tolerances: the
kernel rounds every tap and every step of the solve as PyTorch's
elementwise kernels do, but sums a window in another order than torch.sum,
so a sum differs in its last bits and a convergence test or a gate at its
threshold can flip. So where both report status, positions agree to 1e-3
px and the mean residual to 1e-5; status agrees on at least 99.5% of the
features, and ``quad_match``'s valid mask on at least 99%. An unbatched
call gives the batched call's frame bit for bit (a feature's arithmetic
does not depend on the batch), and ``quad_match`` launches the kernel 4
times a call whatever B is.
"""

import numpy as np
import pytest
import torch

from semantic_slam_mapping_torch.config import KltConfig, SlamConfig
from semantic_slam_mapping_torch.frontend import quadmatch
from semantic_slam_mapping_torch.geometry.camera import Intrinsics
from semantic_slam_mapping_torch.io import synthetic
from semantic_slam_mapping_torch.ops import corners, klt
from semantic_slam_mapping_torch.ops import image as im

torch.set_num_threads(2)
LEVELS = KltConfig().pyramid_levels


def _pyr(img):
    return im.build_pyramid(img, LEVELS, 2.0)


# -- on the CPU ------------------------------------------------------------

def _small_street():
    """Two frames of the parity scene (96x192) as CPU tensors and 64 GFTT
    features of the current left image."""
    from torch_parity_scene import street_frames
    frames = street_frames()
    lc = torch.from_numpy(frames["left"][1])
    lp = torch.from_numpy(frames["left"][0])
    pts = corners.gftt(lc, max_corners=64).xy
    return lc, lp, pts


@pytest.mark.parametrize("init", [None, (-3.0, 1.0)])
def test_cpu_tensors_take_the_plain_version(init):
    lc, lp, pts = _small_street()
    ini = None if init is None else torch.tensor(init).expand_as(pts)
    before = klt.track_pyramid.launches
    out = klt.track_pyramid(_pyr(lc), _pyr(lp), pts, init=ini)
    ref = klt.track_pyramid_plain(_pyr(lc), _pyr(lp), pts, init=ini)
    assert klt.track_pyramid.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("init", ["zero", "flow", "stereo"])
def test_plain_version_is_the_jax_track_pyramid(init):
    import jax.numpy as jnp
    from semantic_slam_mapping_tpu.ops import image as jim
    from semantic_slam_mapping_tpu.ops import klt as jklt

    lc, lp, pts = _small_street()
    n = pts.shape[0]
    ini = {"zero": None,
           "flow": np.tile(np.float32([-3.0, 1.0]), (n, 1)),
           "stereo": np.stack([-np.linspace(0.0, 12.0, n, dtype=np.float32),
                               np.zeros(n, np.float32)], -1)}[init]
    ka = jklt.track_pyramid(
        tuple(jim.build_pyramid(jnp.asarray(lc.numpy()), LEVELS, 2.0)),
        tuple(jim.build_pyramid(jnp.asarray(lp.numpy()), LEVELS, 2.0)),
        jnp.asarray(pts.numpy()),
        init=None if ini is None else jnp.asarray(ini))
    kb = klt.track_pyramid_plain(
        _pyr(lc), _pyr(lp), pts,
        init=None if ini is None else torch.from_numpy(ini))
    sa, sb = np.asarray(ka.status), kb.status.numpy()
    assert (sa == sb).mean() >= 0.97
    both = sa & sb
    assert both.sum() > 20
    np.testing.assert_allclose(np.asarray(ka.xy)[both], kb.xy.numpy()[both],
                               atol=1e-2)
    np.testing.assert_allclose(np.asarray(ka.error)[both],
                               kb.error.numpy()[both], atol=1e-4)


def _bad_inputs(case):
    """(template pyramid, target pyramid, points, init) of a bad call."""
    img = torch.rand(2, 32, 48)
    tp, gp = _pyr(img), _pyr(img.flip(-1))
    pts = torch.rand(2, 5, 2) * 20 + 8
    init = None
    if case == "float64 points":
        pts = pts.double()
    elif case == "float64 level":
        gp[1] = gp[1].double()
    elif case == "points not (..., N, 2)":
        pts = torch.rand(2, 5, 3)
    elif case == "init not like the points":
        init = torch.zeros(2, 4, 2)
    elif case == "pyramids of two depths":
        gp = gp[:2]
    elif case == "batch dims differ":
        pts = pts[0]
    elif case == "mixed devices":
        pts = pts.to("meta")
    return tp, gp, pts, init


@pytest.mark.parametrize("case", [
    "float64 points", "float64 level", "points not (..., N, 2)",
    "init not like the points", "pyramids of two depths",
    "batch dims differ", "mixed devices"])
def test_wrapper_raises_on_bad_inputs(case):
    tp, gp, pts, init = _bad_inputs(case)
    before = klt.track_pyramid.launches
    with pytest.raises(ValueError, match="track_pyramid"):
        klt.track_pyramid(tp, gp, pts, init=init)
    assert klt.track_pyramid.launches == before


# -- on the card -----------------------------------------------------------

B = 4


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@pytest.fixture(scope="module")
def street():
    """B consecutive stereo pairs of a rendered street at 376x1241 on the
    card, their pyramids, 512 GFTT features a frame, the rendered
    disparity, and the zero, stereo and flow-prior inits of the features."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return _street(torch.device("cuda", 0))


def _street(dev):
    K = Intrinsics.from_config(SlamConfig().camera)
    gen = torch.Generator(device=dev).manual_seed(0)
    world = synthetic.make_world(gen, n_boxes=14, with_moving_box=True,
                                 device=dev)
    poses = synthetic.straight_trajectory(B + 1, speed=0.6, device=dev)
    seq = synthetic.render_sequence(K, world, poses, 376, 1241)
    left, right = seq["left"].float(), seq["right"].float()
    img = {"lc": left[1:], "rc": right[1:], "lp": left[:-1],
           "rp": right[:-1]}
    depth = seq["depth"][1:].float()
    disp = torch.where(depth > 0.5, K.bf / depth.clamp(min=0.5), 0.0)
    lc = corners.gftt(img["lc"], max_corners=512).xy
    d0 = im.bilinear_sample(disp, lc).clamp(min=0.0)
    prior = torch.tensor([[1.5, -0.5], [2.0, 0.0], [0.5, 0.5], [3.0, -1.0]],
                         device=dev)
    return dict(
        dev=dev, img=img, pyr={k: _pyr(v) for k, v in img.items()}, lc=lc,
        disp=disp, prior=prior,
        inits={"zero": None,
               "stereo": torch.stack([-d0, torch.zeros_like(d0)], -1),
               "flow": prior[:, None, :].expand_as(lc).contiguous()})


def _agree(kern, plain, what):
    """Raises unless status agrees on 99.5% of the features and, where
    both report status, positions agree within 1e-3 px and residuals
    within 1e-5."""
    _sync(kern.xy.device)
    same = (kern.status == plain.status).float().mean().item()
    assert same >= 0.995, f"{what}: status agrees on {same:.4f}"
    both = kern.status & plain.status
    assert both.any(), what
    dxy = (kern.xy - plain.xy).abs()[both].max().item()
    derr = (kern.error - plain.error).abs()[both].max().item()
    assert dxy <= 1e-3, f"{what}: positions differ by {dxy} px"
    assert derr <= 1e-5, f"{what}: residuals differ by {derr}"


def _legs(s):
    """Every leg of the quad match (template, target, points), the
    points of the later legs from the plain version's earlier legs."""
    p = s["pyr"]
    rc = klt.track_pyramid_plain(p["lc"], p["rc"], s["lc"],
                                 init=s["inits"]["stereo"]).xy
    rp = klt.track_pyramid_plain(p["rc"], p["rp"], rc,
                                 init=s["inits"]["flow"]).xy
    return {"lc_rc": ("lc", "rc", s["lc"]), "rc_rp": ("rc", "rp", rc),
            "rp_lp": ("rp", "lp", rp), "lc_lp": ("lc", "lp", s["lc"])}


@pytest.mark.card
@pytest.mark.parametrize("leg,init", [
    ("lc_rc", "zero"), ("lc_rc", "stereo"), ("rc_rp", "zero"),
    ("rc_rp", "flow"), ("rp_lp", "zero"), ("lc_lp", "zero"),
    ("lc_lp", "flow")])
def test_kernel_matches_plain_on_each_leg(street, leg, init):
    src, dst, pts = _legs(street)[leg]
    tp, gp = street["pyr"][src], street["pyr"][dst]
    ini = street["inits"][init]
    before = klt.track_pyramid.launches
    kern = klt.track_pyramid(tp, gp, pts, init=ini)
    assert klt.track_pyramid.launches == before + 1
    plain = klt.track_pyramid_plain(tp, gp, pts, init=ini)
    _agree(kern, plain, f"{leg} {init}")
    assert plain.status.float().mean().item() > 0.3, (leg, init)

    # one frame alone, (H, W) levels and (N, 2) points: the batched
    # call's frame bit for bit, and the plain version's within tolerance
    one = [[t[0] for t in tp], [t[0] for t in gp], pts[0]]
    ini0 = None if ini is None else ini[0]
    alone = klt.track_pyramid(*one, init=ini0)
    _sync(street["dev"])
    for a, b in zip(alone, kern):
        assert torch.equal(a, b[0]), (leg, init)
    _agree(alone, klt.track_pyramid_plain(*one, init=ini0),
           f"{leg} {init} unbatched")


@pytest.mark.card
def test_kernel_matches_plain_at_the_border(street):
    dev = street["dev"]
    H, W = street["img"]["lc"].shape[-2:]
    gen = torch.Generator(device=dev).manual_seed(1)
    n = 512
    # a quarter of the features within 10 px (the KLT margin) of each side
    near = torch.rand(B, n, generator=gen, device=dev) * 10.0
    along = torch.rand(B, n, 2, generator=gen, device=dev)
    side = torch.arange(n, device=dev) % 4
    x = torch.where(side == 0, near, torch.where(
        side == 1, W - 1 - near, along[..., 0] * (W - 1)))
    y = torch.where(side == 2, near, torch.where(
        side == 3, H - 1 - near, along[..., 1] * (H - 1)))
    pts = torch.stack([x, y], -1)
    tp, gp = street["pyr"]["lc"], street["pyr"]["lp"]
    for init in ("zero", "flow"):
        ini = street["inits"][init]
        _agree(klt.track_pyramid(tp, gp, pts, init=ini),
               klt.track_pyramid_plain(tp, gp, pts, init=ini),
               f"border {init}")


@pytest.mark.card
def test_kernel_matches_plain_where_the_gate_fails(street):
    # a flat 240x400 patch in each template: its gradients are exactly 0
    # at least 20 px (at the coarsest level) inside its edge, so the 256
    # features drawn there fail the eigenvalue gate and keep their guess
    dev = street["dev"]
    lc = street["img"]["lc"].clone()
    lc[:, 60:300, 300:700] = 0.5
    tp, gp = _pyr(lc), street["pyr"]["rc"]
    gen = torch.Generator(device=dev).manual_seed(2)
    flat = (torch.rand(B, 256, 2, generator=gen, device=dev)
            * torch.tensor([140.0, 80.0], device=dev)
            + torch.tensor([430.0, 140.0], device=dev))
    pts = torch.cat([flat, street["lc"][:, :256]], 1)
    ini = street["inits"]["flow"]
    kern = klt.track_pyramid(tp, gp, pts, init=ini)
    plain = klt.track_pyramid_plain(tp, gp, pts, init=ini)
    _sync(dev)
    assert not kern.status[:, :256].any()
    assert not plain.status[:, :256].any()
    assert torch.equal(kern.xy[:, :256], (pts + ini)[:, :256])
    assert torch.equal(plain.xy[:, :256], (pts + ini)[:, :256])
    _agree(kern, plain, "flat patch")


@pytest.mark.card
@pytest.mark.parametrize("batched", [True, False])
def test_quad_match_launches_four_kernels_and_agrees(street, monkeypatch,
                                                     batched):
    pick = (lambda t: t) if batched else (lambda t: t[0])
    args = [pick(street["img"][k]) for k in ("lc", "rc", "lp", "rp")]
    seeds = dict(cur_disparity=pick(street["disp"]),
                 flow_prior=pick(street["prior"]))
    before = klt.track_pyramid.launches
    kern = quadmatch.quad_match(*args, **seeds)
    assert klt.track_pyramid.launches == before + 4
    monkeypatch.setattr(klt, "track_pyramid", klt.track_pyramid_plain)
    plain = quadmatch.quad_match(*args, **seeds)
    _sync(street["dev"])
    same = (kern.valid == plain.valid).float().mean().item()
    assert same >= 0.99, f"valid agrees on {same:.4f}"
    assert plain.valid.float().mean().item() > 0.05
