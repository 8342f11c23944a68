"""The SA ablations and the IoU head of pdanet_tpu_torch against the JAX
package, on the CPU.

Mirrors ``tests/test_sa_variants.py`` (No_Global, Proposal_Aware-CBAM and
EncoderLayer) with the JAX modules as the oracles: ``CBAM`` and
``EncoderLayer`` on the same inputs and weights (outputs within 1e-6 and
2e-5), the variant backbones' parameter trees equal to flax's leaf for
leaf (``load_jax_variables`` consumes every leaf, ``cbam.conv_layer``,
``q_proj`` ... ``norm2`` and the no_global transformer's narrower leaves
among them), their outputs against JAX's, their gradients finite, and an
unknown ``PDA_VARIANT`` refused as JAX refuses it.

Then the two variant layouts the chip check runs at full width, here at
the tiny config's width, through ``build_network``:

* V1: SA1 sampled by FS (16 + 16 picks), ``PDA_VARIANT: no_global``,
  ``PROPOSAL_AWARE_CBAM``, ``POINT_HEAD.IOU_FC``;
* V2: SA0 sampled by ``ds_FPS``, ``POINTFORMER_IMPL: encoder_layer``,
  ``IOU_FC``.

Each at eval in float32 from JAX's weights: the sampled and ball-query
indices equal to JAX's, xyz within 1e-5, sa_ins logits 3e-4, centre
features 1e-3, cls / box / IoU logits 2e-3, the detections equal in count
and within 1e-4 (ROADMAP's tolerances); and one training step in float64:
the loss and every tb term, ``iou3d_loss_reg`` among them, within 1e-6
relative, every gradient leaf within 1e-6 of its scale (its largest
|gradient|, floored at 1e-6 of the largest leaf's) and the BatchNorm
statistics within 1e-9, the tolerances of ``tests/test_torch_train.py``.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from model_cfg import tiny_model_cfg
from pdanet_tpu.models.backbones_3d.iassd_backbone import IASSDBackbone as JIASSDBackbone
from pdanet_tpu.models.blocks import CBAM as JCBAM
from pdanet_tpu.models.blocks import EncoderLayer as JEncoderLayer
from pdanet_tpu.models.detectors import build_network as j_build
from pdanet_tpu.models.detectors.iassd import post_processing as j_post
from pdanet_tpu.ops.ball_query import ball_query_multi as j_ball_query_multi
from pdanet_tpu_torch.models import build_network
from pdanet_tpu_torch.models.backbones_3d.iassd_backbone import IASSDBackbone
from pdanet_tpu_torch.models.blocks import CBAM, EncoderLayer
from pdanet_tpu_torch.models.detectors import get_post_processor
from pdanet_tpu_torch.utils.easydict import EasyDict
from pdanet_tpu_torch.utils.jax_weights import load_jax_variables
from test_sa_variants import _TorchEncoderLayer
from test_torch_parta2 import random_variables
from test_torch_second import _exact_f64
from test_torch_train import _batch

NUM_CLASS = 3
# the batch of the variants' runs: with their weights, two of each variant's
# eight final centres are positives, so that the IoU loss is not 0
BATCH_SEED = 39


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread while this module's tests run: the suite runs
    in several worker processes at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _names(tree):
    return {"/".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _points(B=2, N=128, seed=0):
    """``tests/test_sa_variants.py``'s cloud: uniform, sorted along x."""
    pts = np.random.RandomState(seed).uniform(-4, 4, (B, N, 4)).astype(np.float32)
    return np.take_along_axis(pts, np.argsort(pts[..., 0], axis=1)[..., None], 1)


# --- the blocks ------------------------------------------------------------


def test_cbam_matches_jax():
    x = np.random.RandomState(3).randn(2, 40, 16).astype(np.float32)  # (B, N, C)
    x[0, 5] = 0.0  # a row whose channel max ties everywhere
    jmod = JCBAM()
    var = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    mod = CBAM()
    load_jax_variables(mod, var)
    xt = torch.from_numpy(x).requires_grad_()
    got = mod(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jmod.apply(var, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    got.square().sum().backward()
    want_g = jax.grad(lambda a: jnp.sum(jnp.square(jmod.apply(var, a))))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(3, 8, 48), (2, 5, 8, 24)])
def test_encoder_layer_matches_jax(shape):
    """(B, K, D) and the backbone's (B, M, K, D); the attention core through
    the port's neighbour-attention op, against flax's
    ``dot_product_attention`` and the reference's verbatim torch twin."""
    d, H = shape[-1], 4
    x = np.random.RandomState(7).randn(*shape).astype(np.float32)
    jmod = JEncoderLayer(d_model=d, nhead=H)
    var = jax.device_get(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), False))
    mod = EncoderLayer(d, H)
    load_jax_variables(mod, var)
    assert set(mod.state_dict()) == {f"{n}.{w}" for n in ("q_proj", "k_proj", "v_proj",
                                                          "merge", "mlp_0", "mlp_1")
                                     for w in ("weight",)} | {
        f"norm{i}.{w}" for i in (1, 2) for w in ("weight", "bias")}
    got = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(var, jnp.asarray(x), False)),
                               rtol=2e-5, atol=2e-5)
    if len(shape) == 3:
        twin = _TorchEncoderLayer(d, H)
        twin.load_state_dict({k.replace("mlp_0", "mlp.0").replace("mlp_1", "mlp.2"): v
                              for k, v in mod.state_dict().items()})
        np.testing.assert_allclose(got, twin(torch.from_numpy(x)).detach().numpy(),
                                   rtol=2e-5, atol=2e-5)


# --- the variant backbones -------------------------------------------------


def _variant(**switches):
    cfg = copy.deepcopy(tiny_model_cfg(NUM_CLASS).BACKBONE_3D)
    cfg.SA_CONFIG.update(switches)
    return EasyDict(cfg)


def _both_backbones(cfg3d, pts):
    """The JAX backbone's variables (random, no compile) and eval output,
    and the port's backbone holding them."""
    jbb = JIASSDBackbone(model_cfg=cfg3d, num_class=NUM_CLASS, input_channels=4)
    var = random_variables(jbb, (jnp.asarray(pts),), 5)
    out = jax.device_get(jax.jit(lambda v, p: jbb.apply(v, p))(var, jnp.asarray(pts)))
    model = IASSDBackbone(cfg3d, NUM_CLASS, 4).eval()
    load_jax_variables(model, var)
    assert len(model.state_dict()) == len(jax.tree_util.tree_leaves(var))
    return jbb, var, out, model


@pytest.mark.parametrize("switch", ["no_global", "cbam", "encoder_layer"])
def test_variant_backbone_matches_jax(switch):
    """The variant's parameter tree against the default's, as
    ``test_sa_variants.py`` checks it, and its forward against JAX's."""
    kw = {"no_global": dict(PDA_VARIANT="no_global"),
          "cbam": dict(PROPOSAL_AWARE_CBAM=True),
          "encoder_layer": dict(POINTFORMER_IMPL="encoder_layer")}[switch]
    pts = _points()
    _, var, out, model = _both_backbones(_variant(**kw), pts)
    names = _names(var["params"])
    base = set(IASSDBackbone(_variant(), NUM_CLASS, 4).state_dict())
    keys = set(model.state_dict())
    if switch == "no_global":
        assert not any("global_mlps" in n for n in names | keys)
        assert any("global_mlps" in k for k in base)
        q = model.SA_modules_1.Local_pointformer_0.self_attn.query.weight
        q_base = IASSDBackbone(_variant(), NUM_CLASS, 4).SA_modules_1.Local_pointformer_0 \
            .self_attn.query.weight
        assert q.shape[1] * 4 == q_base.shape[1] * 3
    elif switch == "cbam":
        assert {"SA_modules_0/cbam/conv_layer/kernel",
                "SA_modules_5/cbam/conv_layer/kernel"} <= names
        assert not any(n.startswith(f"SA_modules_{k}/cbam") for n in names for k in (1, 2, 3))
        assert "SA_modules_0.cbam.conv_layer.weight" in keys
    else:
        assert any("Local_pointformer_0/q_proj" in n for n in names)
        assert not any("Local_pointformer_0/self_attn" in n for n in names | keys)
    with torch.no_grad():
        got = model(torch.from_numpy(pts))
    np.testing.assert_allclose(got["centers"].numpy(), out["centers"], atol=1e-5)
    np.testing.assert_allclose(got["centers_features"].numpy(), out["centers_features"],
                               atol=1e-3)
    assert got["centers_features"].shape == out["centers_features"].shape


def test_no_global_grads_flow():
    model = IASSDBackbone(_variant(PDA_VARIANT="no_global"), NUM_CLASS, 4).train()
    out = model(torch.from_numpy(_points()))
    out["centers_features"].square().sum().backward()
    sums = [p.grad.abs().sum().item() for p in model.parameters() if p.grad is not None]
    assert all(np.isfinite(sums))
    assert sum(v > 0 for v in sums) > len(list(model.parameters())) // 2


def test_unknown_variant_rejected():
    with pytest.raises(NotImplementedError, match="PDA_VARIANT=bogus"):
        IASSDBackbone(_variant(PDA_VARIANT="bogus"), NUM_CLASS, 4)
    jbb = JIASSDBackbone(model_cfg=_variant(PDA_VARIANT="bogus"), num_class=NUM_CLASS,
                         input_channels=4)
    with pytest.raises(NotImplementedError):
        jax.eval_shape(lambda p: jbb.init(jax.random.PRNGKey(0), p), jnp.asarray(_points()))


# --- V1 and V2 through build_network -----------------------------------------

VARIANTS = {
    "V1": dict(sa={"SAMPLE_METHOD_LIST": 1, "PDA_VARIANT": "no_global",
                   "PROPOSAL_AWARE_CBAM": True}, fs_layer=1),
    "V2": dict(sa={"SAMPLE_METHOD_LIST": 0, "POINTFORMER_IMPL": "encoder_layer"}),
}


def variant_model_cfg(name):
    """The tiny model with the variant's switches, as the CLIs' ``--set``
    would give them: V1's SA1 samples FS 16 + 16 (its 32 centres), V2's SA0
    ds_FPS; both with ``IOU_FC``."""
    cfg = EasyDict(copy.deepcopy(tiny_model_cfg(NUM_CLASS)))
    sa = cfg.BACKBONE_3D.SA_CONFIG
    if name == "V1":
        sa.SAMPLE_METHOD_LIST[1] = ["FS"]
        sa.NPOINT_LIST[1] = [16]
        sa.PDA_VARIANT = "no_global"
        sa.PROPOSAL_AWARE_CBAM = True
    else:
        sa.SAMPLE_METHOD_LIST[0] = ["ds_FPS"]
        sa.POINTFORMER_IMPL = "encoder_layer"
    cfg.POINT_HEAD.IOU_FC = [16, 16]
    return cfg


def _sampled(inter, sa_cfg):
    out = []
    for k in range(len(sa_cfg.NSAMPLE_LIST)):
        s = None
        if sa_cfg.LAYER_TYPE[k] == "SA_Layer":
            s = inter["backbone_3d"][f"SA_modules_{k}"]["__call__"][0][3]
        out.append(None if s is None else np.asarray(s))
    return out


def _capture(mdl, _):
    return (mdl.name or "").startswith("SA_modules")


@pytest.fixture(scope="module", params=["V1", "V2"])
def variant_run(request):
    """The tiny JAX variant at eval in float32 (forward, its sampled
    indices, post-processing) and one training step in float64 (loss, tb,
    gradient, statistics, sampled indices) on two frames with gt boxes.
    One compile each."""
    name = request.param
    cfg = variant_model_cfg(name)
    pts, gt = _batch(BATCH_SEED)
    jmodel = j_build(cfg, num_class=NUM_CLASS)
    variables = random_variables(jmodel, (jnp.asarray(pts),), 3)

    def predict(v, p):
        out, mut = jmodel.apply(v, p, train=False, capture_intermediates=_capture,
                                mutable=["intermediates"])
        return out, mut["intermediates"], j_post(out["batch_cls_preds"],
                                                 out["batch_box_preds"], cfg.POST_PROCESSING)

    out, inter, post = jax.device_get(jax.jit(predict)(variables, jnp.asarray(pts)))
    with _exact_f64():
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

        def loss_fn(params, p, g):
            def fwd_loss(mdl, p_, g_):
                o = mdl(p_, train=True)
                loss, tb = mdl.loss(o, g_)
                return loss, tb

            (loss, tb), mut = jmodel.apply(
                {"params": params, "batch_stats": v64["batch_stats"]}, p, g,
                mutable=["batch_stats", "intermediates"], method=fwd_loss,
                capture_intermediates=_capture)
            return loss, (tb, mut)

        (loss, (tb, mut)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"], jnp.asarray(pts, jnp.float64), jnp.asarray(gt, jnp.float64))
        f64 = dict(variables=v64, loss=float(loss), tb={k: float(x) for k, x in tb.items()},
                   grads=jax.device_get(grads), stats=jax.device_get(mut["batch_stats"]),
                   samp=_sampled(mut["intermediates"], cfg.BACKBONE_3D.SA_CONFIG))
    return dict(name=name, cfg=cfg, pts=pts, gt=gt, variables=variables, out=out,
                samp=_sampled(inter, cfg.BACKBONE_3D.SA_CONFIG), post=post, f64=f64)


def _check_indices(got, samp, ball_from, sa_cfg):
    for k, want in enumerate(samp):
        if want is not None:
            np.testing.assert_array_equal(got["sampled_idx"][k].numpy(), want,
                                          err_msg=f"sampled L{k}")
        if sa_cfg.LAYER_TYPE[k] == "SA_Layer" and sa_cfg.RADIUS_LIST[k]:
            want_bq = j_ball_query_multi(
                tuple(sa_cfg.RADIUS_LIST[k]), tuple(sa_cfg.NSAMPLE_LIST[k]),
                jnp.asarray(ball_from[sa_cfg.LAYER_INPUT[k]]), jnp.asarray(ball_from[k + 1]))
            for g, w in zip(got["ball_query_idx"][k], want_bq):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"ball L{k}")


def test_variant_eval_equals_jax(variant_run):
    run = variant_run
    cfg, j, sa_cfg = run["cfg"], run["out"], run["cfg"].BACKBONE_3D.SA_CONFIG
    model = build_network(cfg, NUM_CLASS, device="cpu").eval()
    load_jax_variables(model, run["variables"])
    with torch.no_grad():
        out = model(torch.from_numpy(run["pts"]))
        post = get_post_processor("IASSD")(out, cfg)
    if run["name"] == "V1":
        assert out["sampled_idx"][1].shape == (2, 32)
    _check_indices(out, run["samp"], [np.asarray(t) for t in j["encoder_xyz"]], sa_cfg)
    for k in range(len(sa_cfg.NSAMPLE_LIST)):
        np.testing.assert_allclose(out["encoder_xyz"][k + 1].numpy(), j["encoder_xyz"][k + 1],
                                   atol=1e-5, err_msg=f"xyz L{k}")
        if out["sa_ins_preds"][k] is not None:
            np.testing.assert_allclose(out["sa_ins_preds"][k].numpy(), j["sa_ins_preds"][k],
                                       atol=3e-4, err_msg=f"sa_ins L{k}")
    np.testing.assert_allclose(out["centers_features"].numpy(), j["centers_features"], atol=1e-3)
    for key in ("batch_cls_preds", "center_box_preds", "box_iou3d_preds"):
        np.testing.assert_allclose(out[key].numpy(), j[key], atol=2e-3, err_msg=key)
    jp = run["post"]
    np.testing.assert_array_equal(post["pred_counts"].numpy(), jp["pred_counts"])
    np.testing.assert_allclose(post["pred_boxes"].numpy(), jp["pred_boxes"], atol=1e-4)
    np.testing.assert_allclose(post["pred_scores"].numpy(), jp["pred_scores"], atol=1e-4)


def test_variant_float64_step_equals_jax(variant_run):
    run, f64 = variant_run, variant_run["f64"]
    cfg = run["cfg"]
    model = build_network(cfg, NUM_CLASS, device="cpu").double().train()
    load_jax_variables(model, f64["variables"])
    out = model(torch.tensor(run["pts"], dtype=torch.float64))
    loss, tb = model.loss(out, torch.tensor(run["gt"], dtype=torch.float64))
    loss.backward()
    for k, want in enumerate(f64["samp"]):
        if want is not None:
            np.testing.assert_array_equal(out["sampled_idx"][k].numpy(), want)
    assert f64["tb"]["iou3d_loss_reg"] > 0
    assert set(tb) == set(f64["tb"])
    rel = {k: abs(float(tb[k]) - w) / max(abs(w), 1e-12) for k, w in f64["tb"].items()}
    rel["loss"] = abs(loss.item() - f64["loss"]) / abs(f64["loss"])
    assert max(rel.values()) <= 1e-6, rel
    # JAX's gradient in the port's layout: the bridge fills a second model
    want = build_network(cfg, NUM_CLASS, device="cpu").double()
    load_jax_variables(want, {"params": f64["grads"], "batch_stats": f64["stats"]})
    want_sd = want.state_dict()
    grads = {n: p.grad for n, p in model.named_parameters()}
    top = max(w.abs().max().item() for n, w in want_sd.items() if n in grads)
    bad = []
    for name, g in grads.items():
        w = want_sd[name]
        scale = max(w.abs().max().item(), 1e-6 * top)
        err = (g - w).abs().max().item()
        if err > 1e-6 * scale:
            bad.append((name, err / scale))
    assert not bad, bad[:8]
    assert any(n.startswith("point_head.box_iou3d") and g.abs().max() > 0
               for n, g in grads.items())
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_sd[name].numpy(), rtol=1e-9,
                                       atol=1e-9, err_msg=name)
