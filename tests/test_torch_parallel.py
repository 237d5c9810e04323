"""The port's multi-process training against the JAX package's mesh, on the CPU.

Two spawns of gloo processes run every multi-process check of the port once: one of
2 processes and one of 4 (``WORKER``, which imports the port and no JAX). Each rank
writes what it computed to a file; the tests below compare the files with the JAX
package run in this process on a CPU mesh of the same size.

- Losses: every rank passes its rows of one seeded global batch of features to the
  gathered ``clip_loss`` (``local_loss`` on and off) and ``siglip_loss`` (``gather``,
  ``shift``, ``bidir``, ``reduce``; at 4 ranks ``bidir`` is a true two-way ring), and
  backpropagates its loss over the number of ranks. Held against the JAX functions
  inside ``shard_map`` over a ("data",) mesh of as many devices: each rank's loss
  against the shard's, each rank's feature gradients against its rows of the
  gradient of the ``pmean``. Tolerance rtol 1e-5, atol 1e-6.
- The step (4 ranks): a micro ViT in fp32 from JAX ``init_clip`` through
  ``params_from_jax``, under ``shard_model(create_mesh(data=2, fsdp=2))`` with
  ``min_size=1024`` (so that both sharded and whole parameters occur), two steps on
  one global batch of 8 (each rank its 2 rows), then two GradCache steps
  (``accum_steps=2``) from the same weights; held against the JAX package's
  ``make_train_step`` on a (data 2, fsdp 2) mesh with the same global batch. Loss and
  grad norm within rtol 1e-5; every parameter within 2e-2 * lr per step (the
  tolerance of ``test_torch_train_step.py``: Adam's first update divides by |g|).
- The host helpers, a checkpoint written under a (1, 2) mesh and loaded into fresh
  shards, and the CLI under a torchrun-style environment (2 ranks, ``--mesh-fsdp
  2``, one epoch then ``--resume latest``).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from open_clip_tpu.config import CLIPModelCfg as JaxCfg
from open_clip_tpu.loss import clip_loss as jax_clip_loss
from open_clip_tpu.loss import siglip_loss as jax_siglip_loss
from open_clip_tpu.models import clip as jclip
from open_clip_tpu.parallel import distributed as jdist
from open_clip_tpu.parallel import mesh as jmesh
from open_clip_tpu.train import optim as joptim
from open_clip_tpu.train import scheduler as jsched
from open_clip_tpu.train import train_step as jts

import open_clip_tpu_torch as oc
from open_clip_tpu_torch.convert import params_from_jax
from open_clip_tpu_torch.parallel import distributed as pdist
from open_clip_tpu_torch.train import params as pparams
from open_clip_tpu_torch.train import train_step as pts

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
MICRO = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16, "head_width": 32},
    "text_cfg": {"context_length": 16, "vocab_size": 128, "width": 64, "heads": 2, "layers": 2},
}
LR, WARMUP, WD, CLIP = 1e-3, 2, 0.2, 1.0
GLOBAL_BATCH, STEPS, MIN_SIZE = 8, 2, 1024
LOSS_ROWS, LOSS_DIM = 4, 16  # rows per rank, feature width
CLIP_FORMS = ("local", "global")
SIGLIP_IMPLS = ("gather", "shift", "bidir", "reduce")

WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, sys.argv[5])
os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                  MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
import open_clip_tpu_torch as oc
from open_clip_tpu_torch.checkpoint import load_native, save_native
from open_clip_tpu_torch.loss import clip_loss, siglip_loss
from open_clip_tpu_torch.models.clip import CLIPModel
from open_clip_tpu_torch.parallel import distributed as pdist
from open_clip_tpu_torch.parallel.mesh import create_mesh, full_tensor, shard_batch, shard_model
from open_clip_tpu_torch.train import optim, scheduler, train_step
from open_clip_tpu_torch.train.main import main

spec = json.loads(open(os.path.join(work, "spec.json")).read())
out = {}
arrays = {}

# the CLI first: its init_distributed joins the group from the environment; the
# synthetic caption takes the real tokenizer, so this config has the real vocabulary
oc.add_model_config(dict(spec["micro"], text_cfg=dict(spec["micro"]["text_cfg"], vocab_size=49408)),
                    name="par-micro")
logs = os.path.join(work, "logs")
args = ["--model", "par-micro", "--dataset-type", "synthetic", "--train-num-samples", "16",
        "--batch-size", "4", "--lr", "1e-3", "--warmup", "1", "--log-every-n-steps", "1",
        "--log-metric-every-n-steps", "1", "--workers", "1", "--device", "cpu",
        "--logs", logs, "--name", "cli", "--mesh-fsdp", str(world)]
if world == 2:
    s1 = main(args + ["--epochs", "1"])
    out["cli_steps"] = [s1.step]
    s2 = main(args + ["--epochs", "2", "--resume", "latest"])
    out["cli_steps"].append(s2.step)
assert pdist.init_distributed(device="cpu") == (rank, world)  # the CLI's group, or a new one
out["backend"] = dist.get_backend()

# losses: this rank's rows of the global features
feats = np.load(os.path.join(work, "feats.npz"))
b = spec["loss_rows"]
mine = slice(rank * b, (rank + 1) * b)
for name in spec["clip_forms"] + spec["siglip_impls"]:
    imf = torch.from_numpy(feats["imf"][mine]).requires_grad_()
    txf = torch.from_numpy(feats["txf"][mine]).requires_grad_()
    scale, bias = torch.tensor(float(feats["scale"])), torch.tensor(float(feats["bias"]))
    if name in spec["clip_forms"]:
        loss = clip_loss(imf, txf, scale, world_size=world, local_loss=name == "local")
    else:
        loss = siglip_loss(imf, txf, scale, bias, world_size=world, dist_impl=name)
    (loss / world).backward()
    out[f"loss_{name}"] = loss.item()
    arrays[f"gi_{name}"], arrays[f"gt_{name}"] = imf.grad.numpy(), txf.grad.numpy()

# host helpers: rank r holds r + 2 rows (ragged), by a seeded permutation of the
# global row ids; the stride split holds rows r, r + W, ...
counts = [r + 2 for r in range(world)]
total = sum(counts)
perm = np.random.default_rng(1).permutation(total)
idx = perm[sum(counts[:rank]):sum(counts[:rank + 1])]
def rows_of(ids):
    return np.stack([ids * 10.0, -ids]).T.astype(np.float32)
arrays["psum"] = pdist.host_psum([rank + 1.0, 2.0 * rank])
arrays["by_index"] = pdist.host_gather_by_index(rows_of(idx), idx)
arrays["stride"] = pdist.host_gather_stride(rows_of(np.arange(rank, total, world)))
out["bcast"] = pdist.broadcast_scalar_from_primary(rank + 7.0)
out["bcast_obj"] = pdist.broadcast_object_from_primary(f"name-{rank}")
out["host_rows"] = total

cfg = oc.CLIPModelCfg.from_dict(spec["micro"])
weights = torch.load(os.path.join(work, "weights.pt"), weights_only=True)
batch = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(work, "batch.npz")).items()}


def build(mesh, state_dict=weights):
    model = CLIPModel(cfg)
    model.load_state_dict(state_dict)
    shard_model(model, mesh, min_size=spec["min_size"])
    opt = optim.create_optimizer(optim.OptimizerCfg(lr=spec["lr"], wd=spec["wd"],
                                                    grad_clip_norm=spec["clip"]),
                                 model, scheduler.const_lr(spec["lr"], spec["warmup"]))
    return train_step.create_train_state(model, opt), opt


def full_params(state):
    return {k: full_tensor(v).detach().numpy().copy() for k, v in state.model.state_dict().items()}


if world == 4:
    mesh = create_mesh(data=2, fsdp=2, device="cpu")
    for accum in (1, 2):
        state, opt = build(mesh)
        if accum == 1:
            out["sharded"] = sorted(k for k, p in state.model.named_parameters()
                                    if type(p).__name__ == "DTensor")
        step = train_step.make_train_step(cfg, opt, mesh=mesh, accum_steps=accum)
        metrics = []
        for _ in range(spec["steps"]):
            state, m = step(state, shard_batch(batch, mesh))
            metrics.append({k: v.item() for k, v in m.items()})
        out[f"step_accum{accum}"] = metrics
        arrays.update({f"accum{accum}/{k}": v for k, v in full_params(state).items()})
    # full remat: each sharded block recomputed in the backward, under FSDP2's hooks
    state, opt = build(mesh)
    state, m = train_step.make_train_step(cfg, opt, mesh=mesh, remat=True)(
        state, shard_batch(batch, mesh))
    out["step_remat"] = {k: v.item() for k, v in m.items()}
else:
    # a checkpoint round trip under a (1, 2) mesh: one step, save, load into fresh
    # shards built from other weights, and compare the whole tensors
    mesh = create_mesh(data=1, fsdp=2, device="cpu")
    state, opt = build(mesh)
    step = train_step.make_train_step(cfg, opt, mesh=mesh)
    state, _ = step(state, shard_batch(batch, mesh))
    path = os.path.join(work, "ckpt.pt")
    save_native(path, state, epoch=3)
    pdist.barrier()
    other = {k: v + 1.0 for k, v in weights.items()}
    fresh, _ = build(mesh, other)
    out["ckpt_epoch"] = load_native(path, like=fresh)
    same = all(np.array_equal(a, b) for a, b in zip(full_params(state).values(),
                                                     full_params(fresh).values()))
    for key in ("mu", "nu"):
        same = same and all(torch.equal(full_tensor(a), full_tensor(b)) for a, b in
                            zip(state.opt_state[key], fresh.opt_state[key]))
    out["ckpt_same"] = bool(same and fresh.step == state.step
                            and fresh.opt_state["count"] == state.opt_state["count"])
    saved = torch.load(path, weights_only=True)
    out["ckpt_whole"] = all(tuple(v.shape) == tuple(weights[k].shape)
                            for k, v in saved["model"].items())

np.savez(os.path.join(work, f"rank{rank}.npz"), **arrays)
with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
    json.dump(out, fh)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _global_inputs():
    """The seeded inputs every spawn shares: loss features, the micro model's JAX
    params (and their port state dict) and the global batch."""
    rng = np.random.default_rng(0)
    n = 4 * LOSS_ROWS

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    feats = {"imf": unit(rng.standard_normal((n, LOSS_DIM))),
             "txf": unit(rng.standard_normal((n, LOSS_DIM))),
             "scale": np.float32(10.0), "bias": np.float32(-5.0)}
    jcfg = JaxCfg.from_dict(MICRO)
    params = jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(0), jcfg))
    images = rng.standard_normal((GLOBAL_BATCH, 32, 32, 3)).astype(np.float32)
    texts = rng.integers(1, 126, (GLOBAL_BATCH, 16)).astype(np.int32)
    texts[np.arange(GLOBAL_BATCH), rng.integers(2, 16, GLOBAL_BATCH)] = 127
    return feats, jcfg, params, {"image": images, "text": texts}


@pytest.fixture(scope="module")
def inputs():
    return _global_inputs()


def _spawn(world: int, work: Path, inputs) -> list:
    feats, _, params, batch = inputs
    work.mkdir(parents=True, exist_ok=True)
    np.savez(work / "feats.npz", **feats)
    np.savez(work / "batch.npz", **batch)
    torch.save(params_from_jax(params, oc.CLIPModelCfg.from_dict(MICRO)), work / "weights.pt")
    (work / "spec.json").write_text(json.dumps({
        "micro": MICRO, "loss_rows": LOSS_ROWS, "clip_forms": list(CLIP_FORMS),
        "siglip_impls": list(SIGLIP_IMPLS), "min_size": MIN_SIZE, "steps": STEPS,
        "lr": LR, "wd": WD, "clip": CLIP, "warmup": WARMUP}))
    script = work / "worker.py"
    script.write_text(WORKER)
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), port, str(work),
                               str(REPO)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env, cwd=work) for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0])
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{log[-4000:]}"
    return [(json.loads((work / f"rank{r}.json").read_text()), dict(np.load(work / f"rank{r}.npz")))
            for r in range(world)], work


@pytest.fixture(scope="module")
def two(tmp_path_factory, inputs):
    return _spawn(2, tmp_path_factory.mktemp("par2"), inputs)


@pytest.fixture(scope="module")
def four(tmp_path_factory, inputs):
    return _spawn(4, tmp_path_factory.mktemp("par4"), inputs)


def _jax_losses(feats, n: int, name: str):
    """Each shard's loss and the gradient of their mean w.r.t. the global features,
    from the JAX functions inside shard_map over n CPU devices."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    scale, bias = jnp.float32(feats["scale"]), jnp.float32(feats["bias"])

    def core(i, t):
        if name in CLIP_FORMS:
            loss = jax_clip_loss(i, t, scale, axis_name="data", local_loss=name == "local")
        else:
            loss = jax_siglip_loss(i, t, scale, bias, axis_name="data", dist_impl=name)
        return jax.lax.pmean(loss, "data"), loss[None]

    sharded = jax.shard_map(core, mesh=mesh, in_specs=(P("data"), P("data")),
                            out_specs=(P(), P("data")))
    fn = jax.jit(jax.value_and_grad(sharded, argnums=(0, 1), has_aux=True))
    (_, per_shard), (gi, gt) = fn(jnp.asarray(feats["imf"][:n * LOSS_ROWS]),
                                  jnp.asarray(feats["txf"][:n * LOSS_ROWS]))
    return np.asarray(per_shard), np.asarray(gi), np.asarray(gt)


def _check_losses(results, feats):
    n = len(results)
    for name in CLIP_FORMS + SIGLIP_IMPLS:
        want, gi, gt = _jax_losses(feats, n, name)
        got = np.array([out[f"loss_{name}"] for out, _ in results])
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
        for key, ref in (("gi", gi), ("gt", gt)):
            grads = np.concatenate([arr[f"{key}_{name}"] for _, arr in results])
            np.testing.assert_allclose(grads, ref, rtol=RTOL, atol=ATOL, err_msg=f"{key} {name}")


def test_losses_match_jax_shard_map_at_2_ranks(two, inputs):
    _check_losses(two[0], inputs[0])


def test_losses_match_jax_shard_map_at_4_ranks(four, inputs):
    _check_losses(four[0], inputs[0])


def test_processes_joined_one_gloo_group(two, four):
    assert {out["backend"] for out, _ in two[0] + four[0]} == {"gloo"}


def test_host_helpers_match_numpy(two):
    results, _ = two
    n = len(results)
    for out, arr in results:
        total = out["host_rows"]
        ids = np.arange(total, dtype=np.float32)
        want = np.stack([ids * 10.0, -ids]).T
        np.testing.assert_array_equal(arr["psum"], [sum(r + 1.0 for r in range(n)),
                                                    sum(2.0 * r for r in range(n))])
        np.testing.assert_array_equal(arr["by_index"], want)
        np.testing.assert_array_equal(arr["stride"], want)
        assert out["bcast"] == 7.0 and out["bcast_obj"] == "name-0"


def test_checkpoint_round_trip_across_two_processes(two):
    results, _ = two
    for out, _ in results:
        assert out["ckpt_epoch"] == 3 and out["ckpt_same"] and out["ckpt_whole"]


def test_cli_trains_and_resumes_under_torchrun_env(two):
    """Two processes, ``--mesh-fsdp 2``, 4 identical samples a rank: the gathered loss
    is ln 8 (a one-process loss would be ln 4); only the primary writes results."""
    results, work = two
    assert all(out["cli_steps"] == [4, 8] for out, _ in results)
    run = work / "logs" / "cli"
    rows = [json.loads(x) for x in (run / "results.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == list(range(1, 9))
    assert all(abs(r["train/loss"] - np.log(8)) < 1e-4 for r in rows), rows
    assert (run / "checkpoints" / "epoch_1.pt").exists() and (run / "checkpoints" / "epoch_2.pt").exists()
    assert "world_size: 2" in (run / "params.txt").read_text()


def _jax_steps(jcfg, params, batch, accum: int):
    mesh = jmesh.create_mesh(data=2, fsdp=2, devices=jax.devices()[:4])
    jparams = jax.device_put(jax.tree.map(jnp.asarray, params),
                             jmesh.fsdp_shardings(params, mesh, min_size=MIN_SIZE))
    opt = joptim.create_optimizer(joptim.OptimizerCfg(lr=LR, wd=WD, grad_clip_norm=CLIP),
                                  jparams, jsched.const_lr(LR, WARMUP))
    state = jmesh.place_on_mesh(jts.create_train_state(jparams, opt), mesh)
    step = jts.jit_train_step(jts.make_train_step(jcfg, opt, mesh=mesh, compute_dtype=jnp.float32,
                                                  accum_steps=accum), mesh)
    gbatch = jmesh.put_global_batch({k: jnp.asarray(v) for k, v in batch.items()},
                                    NamedSharding(mesh, P(jmesh.DATA_AXIS)))
    metrics = []
    for i in range(STEPS):
        state, m = step(state, gbatch, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("accum", [1, 2])
def test_mesh_step_matches_jax(four, inputs, accum):
    """(data 2, fsdp 2) on 4 processes against the JAX mesh step, two steps."""
    _, jcfg, params, batch = inputs
    want, jparams = _jax_steps(jcfg, params, batch, accum)
    for out, _ in four[0]:
        got = out[f"step_accum{accum}"]
        for g, w in zip(got, want):
            for key in ("loss", "grad_norm", "logit_scale"):
                assert g[key] == pytest.approx(w[key], rel=RTOL), (key, g, w)
    wanted = params_from_jax(jparams, oc.CLIPModelCfg.from_dict(MICRO))
    arrays = four[0][0][1]
    for key, ref in wanted.items():
        got = arrays[f"accum{accum}/{key}"]
        assert got.shape == tuple(ref.shape), key
        assert np.abs(got - ref.numpy()).max() <= 2e-2 * LR * STEPS, key


def test_mesh_step_with_remat_repeats_the_step(four):
    for out, _ in four[0]:
        first, remat = out["step_accum1"][0], out["step_remat"]
        for key in ("loss", "grad_norm", "logit_scale"):
            assert remat[key] == pytest.approx(first[key], rel=1e-6), key


def test_mesh_shards_the_large_leaves_only(four):
    sharded = set(four[0][0][0]["sharded"])
    cfg = oc.CLIPModelCfg.from_dict(MICRO)
    model = oc.CLIPModel(cfg)
    want = {k for k, p in model.named_parameters() if p.ndim > 0 and p.numel() >= MIN_SIZE}
    assert sharded == want and "logit_scale" not in sharded
    assert "visual.transformer.resblocks.0.attn.in_proj_weight" in sharded


ENV_CASES = [
    {"OCT_COORDINATOR": "host:1234", "OCT_NUM_PROCESSES": "4", "OCT_PROCESS_ID": "2"},
    {"MASTER_ADDR": "h2", "MASTER_PORT": "29500", "WORLD_SIZE": "8", "RANK": "5"},
    {"MASTER_ADDR": "h3:7", "SLURM_NTASKS": "2", "SLURM_PROCID": "1", "WORLD_SIZE": "2"},
    {"SLURM_NTASKS": "16", "SLURM_PROCID": "3", "MASTER_ADDR": "h4"},
    {"OCT_COORDINATOR": "c:1", "OCT_NUM_PROCESSES": "2", "WORLD_SIZE": "2", "RANK": "1"},
    {},
]


@pytest.mark.parametrize("env", ENV_CASES)
def test_world_info_from_env_matches_jax(monkeypatch, env):
    for var in ("OCT_COORDINATOR", "OCT_NUM_PROCESSES", "OCT_PROCESS_ID", "MASTER_ADDR",
                "MASTER_PORT", "WORLD_SIZE", "RANK", "SLURM_NTASKS", "SLURM_PROCID",
                "LOCAL_RANK", "SLURM_LOCALID"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert pdist.world_info_from_env() == jdist.world_info_from_env()


def test_local_rank_from_env(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("SLURM_LOCALID", raising=False)
    assert pdist.local_rank_from_env() == 0
    monkeypatch.setenv("SLURM_LOCALID", "3")
    assert pdist.local_rank_from_env() == 3
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pdist.local_rank_from_env() == 1


def test_init_distributed_without_a_world_is_one_process(monkeypatch):
    for var in ("OCT_NUM_PROCESSES", "WORLD_SIZE", "SLURM_NTASKS", "MASTER_ADDR", "OCT_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    assert pdist.init_distributed(device="cpu") == (0, 1)
    monkeypatch.setenv("SLURM_NTASKS", "1")  # a one-task job names no coordinator
    monkeypatch.setenv("SLURM_PROCID", "0")
    assert pdist.init_distributed(device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("kw,match", [
    ({"coordinator": "127.0.0.1:1", "num_processes": 2}, "process id"),
    ({"num_processes": 2, "process_id": 1}, "coordinator"),
])
def test_init_distributed_refuses_half_a_world(monkeypatch, kw, match):
    for var in ("OCT_COORDINATOR", "MASTER_ADDR", "RANK", "OCT_PROCESS_ID", "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=match):
        pdist.init_distributed(**kw, device="cpu")
    assert not torch.distributed.is_initialized()


def test_launch_script_flags_are_accepted():
    ns = pparams.parse_args(["--dist-backend", "nccl", "--dist-url", "env://", "--fsdp",
                             "--fsdp-checkpoint", "--fsdp-no-reshard-after-forward",
                             "--fsdp-offload-cpu", "--ddp-static-graph", "--no-set-device-rank",
                             "--use-bn-sync", "--mesh-fsdp", "2", "--mesh-data", "2",
                             "--dist-num-processes", "4", "--dist-process-id", "1",
                             "--dist-coordinator", "h:1", "--loss-dist-impl", "shift",
                             "--no-local-loss"])
    assert (ns.mesh_fsdp, ns.mesh_data, ns.loss_dist_impl, ns.local_loss) == (2, 2, "shift", False)


@pytest.mark.parametrize("extra", [["--mesh-tensor", "2"], ["--torchcompile"],
                                   ["--torchcompile-mode", "max-autotune"]])
def test_tensor_parallel_and_compile_flags_raise(extra):
    with pytest.raises(NotImplementedError, match=extra[0]):
        pparams.parse_args(extra)


def test_mesh_step_refuses_switchback_and_remat_presets():
    from open_clip_tpu_torch.models import blocks

    cfg = oc.CLIPModelCfg.from_dict(MICRO)
    opt = oc.create_optimizer(oc.OptimizerCfg(), oc.CLIPModel(cfg), oc.const_lr(LR, 0))
    fake_mesh = type("Mesh", (), {"size": lambda self: 2})()
    saved = blocks.MLP_LINEAR_IMPL, blocks.REMAT_POLICY
    try:
        for impl, policy in (("switchback", "none"), ("dense", "names_mm")):
            blocks.MLP_LINEAR_IMPL, blocks.REMAT_POLICY = impl, policy
            with pytest.raises(NotImplementedError, match="under a mesh"):
                pts.make_train_step(cfg, opt, mesh=fake_mesh)
    finally:
        blocks.MLP_LINEAR_IMPL, blocks.REMAT_POLICY = saved
