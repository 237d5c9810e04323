"""The port's SwitchBack int8 linear, its hook in the blocks, the selective remat
presets and their CLI flags, against the JAX package on the CPU.

The JAX package's Pallas kernel runs in interpret mode, as its own tests run it;
the port's wrapper takes the plain version for CPU tensors. Inputs from a numpy
seed. Tolerances, with their reasons:

- quantization: exact. Where XLA's rewrite of the division rounds a tie the other
  way, such a value may differ by one level and no more (counted and bounded);
- the int8 product: exact (integers summed exactly, then the same fp32 roundings);
- ``switchback_linear`` in fp32: the forward exact up to the quantization ties,
  the gradients 1e-6 relative (fp32 products summed in other orders);
- train steps with the hook: a value at a rounding tie of its quantization lands
  one level apart once the activations entering an MLP differ by ~1e-7 (fp32 sums
  in other orders), and moves that output by one quantum. The port's own features
  move by ~1e-2 when its token embeddings are perturbed by 1e-7 relative, so
  losses agree to 5e-3 relative and grad norms to 1e-2. Adam's first update is
  ~sign(g), so where a gradient entry is near zero such a difference flips it: the
  parameters are held to 2.5 * lr per step for every entry (a flip moves one by at
  most 2 * lr) and to 5e-2 * lr per step for all but 2 % (at least 2) of each
  tensor's entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.models import blocks as jblocks
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.ops import switchback as jsb
from open_clip_tpu.train import optim as joptim
from open_clip_tpu.train import scheduler as jsched
from open_clip_tpu.train import train_step as jts

import open_clip_tpu_torch as oc
from open_clip_tpu_torch.convert import params_from_jax
from open_clip_tpu_torch.models import blocks as pblocks
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.ops import switchback as psb
from open_clip_tpu_torch.train import optim as poptim
from open_clip_tpu_torch.train import params as pparams
from open_clip_tpu_torch.train import scheduler as psched
from open_clip_tpu_torch.train import train_step as pts
from open_clip_tpu_torch.train.main import main

TINY = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16, "head_width": 32},
    "text_cfg": {"context_length": 16, "width": 64, "heads": 2, "layers": 2},
}
NAME = "tiny-torch-switchback"
LR, WARMUP, WD, CLIP = 1e-3, 2, 0.2, 1.0
BATCH = 8
RAGGED = [(5, 16, 3), (9, 24, 13), (33, 40, 7), (130, 72, 129), (1, 1, 1)]  # (M, K, N)


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxCfg.from_dict(TINY)
    params = jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(0), jcfg))
    cfg = oc.CLIPModelCfg.from_dict(TINY)
    if NAME not in oc.list_models():
        oc.add_model_config(dict(TINY), name=NAME)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    texts = rng.integers(1, 49406, (BATCH, 16)).astype(np.int32)
    texts[:, 0] = 49406
    texts[np.arange(BATCH), rng.integers(2, 16, BATCH)] = 49407
    return jcfg, params, cfg, images, texts


@pytest.fixture
def switchback_on():
    """MLP_LINEAR_IMPL = "switchback" in both packages for one test."""
    saved = jblocks.MLP_LINEAR_IMPL, pblocks.MLP_LINEAR_IMPL
    jblocks.MLP_LINEAR_IMPL = pblocks.MLP_LINEAR_IMPL = "switchback"
    try:
        yield
    finally:
        jblocks.MLP_LINEAR_IMPL, pblocks.MLP_LINEAR_IMPL = saved


def _assert_quantized_equal(got_q, got_s, want_q, want_s):
    """Scales exactly; int8 values exactly, except values that XLA's rewrite of the
    division may round the other way at a tie: those are at most one level apart."""
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    diff = np.abs(got_q.numpy().astype(np.int32) - np.asarray(want_q).astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).sum() <= max(1, diff.size // 1000), (diff > 0).sum()


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 33), (4, 3, 16), (1, 5)])
def test_quantize_rowwise_matches_jax(shape):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10.0, shape[:-1] + (1,))).astype(np.float32)
    rows = x.reshape(-1, shape[-1])
    if len(rows) > 1:
        rows[0] = 0.0  # a zero row: its scale is 1e-8 / 127 and its values 0
    q, s = psb.quantize_rowwise(torch.from_numpy(x))
    jq, js = jsb.quantize_rowwise(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and q.shape == x.shape
    _assert_quantized_equal(q, s, jq, js)
    assert q.reshape(-1, shape[-1]).abs().amax(dim=-1).tolist() == [0] * (len(rows) > 1) + [127] * (
        len(rows) - (len(rows) > 1))


def test_quantize_colwise_matches_jax():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    w[:, 5] = 0.0  # a zero column
    q, s = psb.quantize_colwise(torch.from_numpy(w))
    jq, js = jsb.quantize_colwise(jnp.asarray(w))
    _assert_quantized_equal(q, s, jq, js)
    # the port's kernel layout: the (N, K) weight quantized per row is the same thing
    qr, sr = psb.quantize_rowwise(torch.from_numpy(w.T.copy()))
    assert torch.equal(qr, q.t()) and torch.equal(sr, s)


def _tie_rows(k):
    """Rows whose quotients x / scale sit exactly on .5 ties: absmax 127 (scale 1),
    254 (scale 2) and 63.5 (scale 0.5), the other values k + 0.5 (times the scale),
    every one representable in bf16; then an all-zero row."""
    rows = np.zeros((4, k), np.float32)
    halves = (np.arange(k) % 253 - 126) + 0.5  # -125.5 .. 126.5
    for i, s in enumerate((1.0, 2.0, 0.5)):
        rows[i] = np.clip(halves, -126.5, 126.5) * s
        rows[i, 0] = 127.0 * s * (-1) ** i  # the absmax, positive or negative
    return rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 7, 40, 1280])
def test_quantize_rowwise_is_the_plain_version_and_jax_bit_for_bit(k, dtype):
    """On CPU tensors the dispatcher takes the plain version, launches nothing, and
    equals the JAX package's quantization bit for bit: random rows of mixed ranges,
    rows at .5 ties (rounded half to even), an all-zero row."""
    rng = np.random.default_rng(k)
    rand = (rng.standard_normal((9, k)) * rng.uniform(0.01, 10.0, (9, 1))).astype(np.float32)
    x = torch.from_numpy(np.concatenate([rand, _tie_rows(k)])).to(getattr(torch, dtype))
    psb.LAUNCHES["quantize"] = 0
    q, s = psb.quantize_rowwise(x)
    assert psb.LAUNCHES["quantize"] == 0  # the CPU takes the plain version: no launch
    pq, ps = psb.quantize_rowwise_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    jq, js = jsb.quantize_rowwise(jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[-1].item() == np.float32(1e-8) / np.float32(127) and not q[-1].any()
    if k >= 7:  # the ties went to the even neighbour: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
        ties = x[9:12, 1:].float() / s[9:12, None]
        assert torch.equal(ties - ties.floor(), torch.full_like(ties, 0.5))
        assert (q[9:12, 1:].int() % 2 == 0).all()


def test_quantize_rowwise_raises_off_the_cpu_and_the_card():
    with pytest.raises(ValueError, match="device"):
        psb.quantize_rowwise(torch.zeros(2, 4, device="meta"))


@pytest.mark.parametrize("k,aligned,body", [
    (1, True, "mma"), (16, True, "wgmma"), (24, True, "mma"), (80, True, "wgmma"),
    (1280, True, "wgmma"), (1, False, "mma"), (16, False, "mma"), (24, False, "mma"),
    (80, False, "mma"), (1280, False, "mma")])
def test_matmul_body(k, aligned, body):
    """wgmma where TMA can read both operands (K % 16 == 0, aligned bases), else mma:
    by shape alone, so the ragged shapes of the tests keep the mma body."""
    assert psb.matmul_body(k, aligned) == body


@pytest.mark.parametrize("m,k,n", RAGGED)
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_matmul_dequant_matches_the_pallas_kernel(m, k, n, out_dtype):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    qx = rng.integers(-127, 128, (m, k)).astype(np.int8)
    qw = rng.integers(-127, 128, (k, n)).astype(np.int8)  # the JAX (K, N) layout
    qx[0] = 0  # a zero row
    qw[:, -1] = 0  # a zero column
    sx = rng.uniform(1e-3, 1e-1, m).astype(np.float32)
    sw = rng.uniform(1e-3, 1e-1, n).astype(np.float32)
    want = jsb.int8_matmul_dequant(jnp.asarray(qx), jnp.asarray(qw), jnp.asarray(sx),
                                   jnp.asarray(sw), out_dtype=getattr(jnp, out_dtype),
                                   interpret=True)
    args = (torch.from_numpy(qx), torch.from_numpy(qw.T.copy()), torch.from_numpy(sx),
            torch.from_numpy(sw))
    got = psb.int8_matmul_dequant(*args, out_dtype=getattr(torch, out_dtype))
    plain = psb.int8_matmul_dequant_plain(*args, out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (m, n)
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_int8_matmul_dequant_checks_its_inputs():
    qx, qw = torch.zeros(2, 4, dtype=torch.int8), torch.zeros(3, 4, dtype=torch.int8)
    sx, sw = torch.ones(2), torch.ones(3)
    with pytest.raises(ValueError, match="int32"):  # one past the int32 limit of the sum
        k = psb.MAX_K + 1
        psb.int8_matmul_dequant(torch.zeros(1, k, dtype=torch.int8),
                                torch.zeros(1, k, dtype=torch.int8), torch.ones(1), torch.ones(1))
    assert 127 ** 2 * psb.MAX_K < 2 ** 31 <= 127 ** 2 * (psb.MAX_K + 1)
    with pytest.raises(ValueError, match="int8"):
        psb.int8_matmul_dequant(qx.float(), qw, sx, sw)
    with pytest.raises(ValueError, match=r"\(N, K\)"):
        psb.int8_matmul_dequant(qx, qw.t(), sx, sw)
    with pytest.raises(ValueError, match="scales"):
        psb.int8_matmul_dequant(qx, qw, sw, sx)
    with pytest.raises(ValueError, match="out_dtype"):
        psb.int8_matmul_dequant(qx, qw, sx, sw, out_dtype=torch.float16)
    psb.LAUNCHES["fwd"] = 0
    assert psb.int8_matmul_dequant(qx, qw, sx, sw).shape == (2, 3)
    assert psb.LAUNCHES["fwd"] == 0  # the CPU takes the plain version: no launch


def _linear_inputs(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 40)).astype(np.float32)
    kernel = (0.2 * rng.standard_normal((40, 24))).astype(np.float32)  # JAX (in, out)
    bias = (0.1 * rng.standard_normal(24)).astype(np.float32)
    g = rng.standard_normal((2, 9, 24)).astype(np.float32)
    return x, kernel, bias, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_switchback_linear_and_its_gradients_match_jax(dtype):
    """Forward, dx, dw, db against the JAX custom_vjp, with the fp32 master weight and
    bias under fp32 or bf16 activations (the weight is quantized in fp32 in both)."""
    x, kernel, bias, g = _linear_inputs(dtype)
    jdt = getattr(jnp, dtype)

    def jloss(x_, k_, b_):
        y = jsb.switchback_linear(x_, k_, b_, True)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g)), y

    (_, jy), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x).astype(jdt), jnp.asarray(kernel), jnp.asarray(bias))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    tw = torch.from_numpy(kernel.T.copy()).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    y = psb.switchback_linear(tx, tw, tb)
    (y.float() * torch.from_numpy(g)).sum().backward()
    assert y.dtype == tx.dtype and tw.grad.dtype == torch.float32
    np.testing.assert_array_equal(y.float().detach().numpy(), np.asarray(jy.astype(jnp.float32)))
    rtol = 1e-6 if dtype == "float32" else 1e-2
    for got, want in ((tx.grad, jgrads[0]), (tw.grad.t(), jgrads[1]), (tb.grad, jgrads[2])):
        want = np.asarray(want.astype(jnp.float32))
        diff = np.abs(got.float().numpy() - want).max()
        assert diff <= rtol * np.abs(want).max(), diff


def test_switchback_saves_x_and_the_weight_only():
    x, kernel, bias, _ = _linear_inputs("float32")
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(kernel.T.copy()).requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        psb.switchback_linear(tx, tw, torch.from_numpy(bias))
    assert {t.dtype for t in saved} == {torch.float32}
    assert sorted(tuple(t.shape) for t in saved) == [(18, 40), (24, 40)]


# ---------------------------------------------------------------------------
# the hook in the towers and the train step
# ---------------------------------------------------------------------------

def _port_state(params, cfg):
    model = CLIPModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    opt = poptim.create_optimizer(poptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP), model,
                                  psched.const_lr(LR, WARMUP))
    return pts.create_train_state(model, opt), opt


def _close_params(got, want, atol, flips=0.0, flip_atol=None):
    """Every entry within ``atol``; with ``flips``, all but that share of each
    tensor's entries (at least 2) within ``atol`` and the rest within ``flip_atol``."""
    assert set(got) == set(want)
    for key in want:
        diff = np.abs(got[key].detach().float().numpy() - want[key].float().numpy())
        if flips:
            assert (diff > atol).sum() <= max(2, flips * diff.size), (key, (diff > atol).sum())
            assert diff.max() <= flip_atol, (key, diff.max())
        else:
            assert diff.max() <= atol, (key, diff.max())


def test_hook_routes_both_mlp_linears(setup, switchback_on):
    _, params, cfg, images, texts = setup
    model = _port_state(params, cfg)[0].model
    calls = []
    real = psb._SwitchBack.apply

    def spy(x2, w):
        calls.append(tuple(w.shape))
        return real(x2, w)

    psb._SwitchBack.apply = spy
    try:
        with torch.no_grad():
            oc.encode_image(model, torch.from_numpy(images))
            oc.encode_text(model, torch.from_numpy(texts))
    finally:
        psb._SwitchBack.apply = real
    # c_fc (4 * width, width) and c_proj (width, 4 * width) of every block of both towers
    assert calls == [(256, 64), (64, 256)] * 4


def test_one_and_three_steps_match_jax(setup, switchback_on):
    jcfg, params, cfg, images, texts = setup
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = joptim.create_optimizer(joptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP), jparams,
                                   jsched.const_lr(LR, WARMUP))
    jstate = jts.create_train_state(jparams, jopt)
    jstep = jax.jit(jts.make_train_step(jcfg, jopt, compute_dtype=jnp.float32))
    jbatch = {"image": jnp.asarray(images), "text": jnp.asarray(texts)}
    state, opt = _port_state(params, cfg)
    step = pts.make_train_step(cfg, opt)
    batch = {"image": torch.from_numpy(images), "text": torch.from_numpy(texts)}
    dense = pblocks.MLP_LINEAR_IMPL
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(i))
        state, m = step(state, batch)
        assert m["loss"].item() == pytest.approx(float(jm["loss"]), rel=5e-3)
        assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=1e-2)
        if i in (0, 2):
            want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
            _close_params(state.model.state_dict(), want, atol=5e-2 * LR * (i + 1), flips=0.02,
                          flip_atol=2.5 * LR * (i + 1))
    assert dense == "switchback"


@pytest.mark.parametrize("switchback", [False, True], ids=["dense", "switchback"])
@pytest.mark.parametrize("policy", ["names", "names_mm"])
def test_remat_presets_match_full_remat(setup, policy, switchback):
    """Selective remat changes what the backward keeps, never the math: the loss and
    the updated weights equal full remat's (the port's counterpart of
    tests/test_train_step.py::test_remat_policy_matches_full_remat)."""
    _, params, cfg, images, texts = setup
    batch = {"image": torch.from_numpy(images), "text": torch.from_numpy(texts)}
    saved = pblocks.REMAT_POLICY, pblocks.MLP_LINEAR_IMPL
    results = []
    try:
        pblocks.MLP_LINEAR_IMPL = "switchback" if switchback else "dense"
        for p in ("none", policy):
            pblocks.REMAT_POLICY = p
            state, opt = _port_state(params, cfg)
            state, m = pts.make_train_step(cfg, opt, remat=True)(state, batch)
            results.append((m["loss"].item(), state.model.state_dict()))
    finally:
        pblocks.REMAT_POLICY, pblocks.MLP_LINEAR_IMPL = saved
    (loss_full, full), (loss_sel, sel) = results
    assert loss_sel == pytest.approx(loss_full, rel=1e-6)
    _close_params(sel, full, atol=1e-6)


def test_names_mm_saves_the_projections_and_reruns_no_tagged_product(setup):
    """Under names_mm the backward's recompute takes the qkv and c_fc products from
    what the forward saved: each tagged product runs once a step, against twice
    under full remat. Counted where the ops execute, below the checkpoint's own
    dispatch modes (a cached op never reaches it)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from open_clip_tpu_torch.ops import layers as players

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.runs = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            tag = players.REMAT_TAG
            if tag is not None and func is torch.ops.aten.mm.default:
                self.runs[tag] = self.runs.get(tag, 0) + 1
            return func(*args, **(kwargs or {}))

    _, params, cfg, images, _ = setup
    model = _port_state(params, cfg)[0].model
    saved = pblocks.REMAT_POLICY
    runs = {}
    try:
        for policy in ("none", "names_mm"):
            pblocks.REMAT_POLICY = policy
            with Count() as count:
                oc.encode_image(model, torch.from_numpy(images), remat=True).sum().backward()
            runs[policy] = count.runs
    finally:
        pblocks.REMAT_POLICY = saved
    assert runs["none"] == {"remat_qkv": 4, "remat_fc1": 4}  # 2 blocks, forward + recompute
    assert runs["names_mm"] == {"remat_qkv": 2, "remat_fc1": 2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("switchback", [False, True], ids=["dense", "switchback"])
def test_each_remat_tag_covers_one_op(setup, switchback, dtype):
    """A policy saves the outputs of the ops run under a tag, so each tag must cover
    the one op that makes the named tensor, once per block, and no view of an input
    (which would keep that input alive)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from open_clip_tpu_torch.ops import layers as players

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if players.REMAT_TAG is not None:
                self.ops.setdefault(players.REMAT_TAG, []).append(str(func))
            return func(*args, **(kwargs or {}))

    _, params, cfg, images, texts = setup
    model = _port_state(params, cfg)[0].model
    model.compute_dtype = getattr(torch, dtype)
    saved = pblocks.MLP_LINEAR_IMPL
    try:
        pblocks.MLP_LINEAR_IMPL = "switchback" if switchback else "dense"
        with Record() as rec, torch.no_grad():
            oc.encode_image(model, torch.from_numpy(images))
            oc.encode_text(model, torch.from_numpy(texts))
    finally:
        pblocks.MLP_LINEAR_IMPL = saved
    ln = "aten.native_layer_norm.default" if dtype == "float32" else "aten._to_copy.default"
    fc1 = "oct.switchback_fwd.default" if switchback else "aten.mm.default"
    want = {"remat_ln1": ln, "remat_qkv": "aten.mm.default", "remat_attn_ctx": "aten.clone.default",
            "remat_ln2": ln, "remat_fc1": fc1, "remat_act": "aten.gelu.default"}
    assert rec.ops == {tag: [op] * 4 for tag, op in want.items()}  # 4 blocks, both towers


def test_unported_remat_policies_raise(setup):
    _, params, cfg, images, _ = setup
    model = _port_state(params, cfg)[0].model
    saved = pblocks.REMAT_POLICY
    try:
        pblocks.REMAT_POLICY = "names_custom"  # the JAX package's programmatic preset
        with pytest.raises(NotImplementedError, match="names_custom"):
            oc.encode_image(model, torch.from_numpy(images), remat=True)
    finally:
        pblocks.REMAT_POLICY = saved


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--use-switchback"], ["--use-bnb-linear", "SwitchBackLinearGlobal"],
                                   ["--use-switchback", "--remat-policy", "names_mm"]])
def test_cli_takes_switchback_and_remat_flags(setup, tmp_path, flags, monkeypatch):
    ns = pparams.parse_args(["--model", NAME, *flags])
    assert ns.use_switchback
    seen = {}
    real = pts.make_train_step

    def spy(*args, **kwargs):
        seen["impl"], seen["policy"] = pblocks.MLP_LINEAR_IMPL, pblocks.REMAT_POLICY
        return real(*args, **kwargs)

    monkeypatch.setattr("open_clip_tpu_torch.train.main.make_train_step", spy)
    state = main(["--model", NAME, "--dataset-type", "synthetic", "--train-num-samples", "16",
                  "--batch-size", "8", "--epochs", "1", "--lr", "1e-3", "--warmup", "1",
                  "--precision", "fp32", "--grad-checkpointing", "--logs", str(tmp_path),
                  "--name", "sb", "--device", "cpu", *flags])
    assert state.step == 2
    assert seen == {"impl": "switchback",
                    "policy": "names_mm" if "names_mm" in flags else "none"}
    assert (pblocks.MLP_LINEAR_IMPL, pblocks.REMAT_POLICY) == ("dense", "none")  # restored
