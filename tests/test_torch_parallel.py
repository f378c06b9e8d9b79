"""The port's data parallel (vatl4pose_tpu_torch/parallel, Retrainer(mesh=),
ScoringEngine(mesh=), --data_parallel) on the CPU with gloo ranks, against
the port's one-process run and the JAX package's mesh on the 8-device
virtual CPU mesh (tests/conftest.py), at tests/test_sharding.py's bounds.

The ranks are spawned processes (torch.multiprocessing, "spawn") that meet
through a FileStore under tmp_path, so that no TCP port is shared between
test workers; the CLI loop runs under torchrun.  The workers live in this
file, whose top level imports no JAX (a spawned child imports it): JAX is
imported inside the test functions and the fixtures, in this process only.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
from vatl4pose_tpu_torch.data import AugCfg, build_dataset
from vatl4pose_tpu_torch.models import SimplePose
from vatl4pose_tpu_torch.models.criterion import masked_heatmap_loss
from vatl4pose_tpu_torch.models.layers import batchnorm
from vatl4pose_tpu_torch.parallel import (Sharding, all_gather,
                                          all_reduce_grads,
                                          build_sharded_eval_step,
                                          build_sharded_train_step,
                                          init_multihost, make_mesh,
                                          shard_batch)
from vatl4pose_tpu_torch.train import Retrainer, build_optimizer, set_lr

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
RCFG = {"OPTIMIZER": "AdamW", "LR": 2.5e-4, "LR_GAMMA": 0.99,
        "BATCH_SIZE": 8, "WEIGHT_DECAY": 0.7}
LR = 2.5e-4
AUG = dict(scale_factor=0.0, rot_factor=0, flip=False)
INPUT, HM = (64, 64), (16, 16)


# ---- the ranks -------------------------------------------------------------
def _start(job, world, tmp, init="file"):
    """Start `job` on `world` gloo ranks; `_join` waits for them."""
    return mp.start_processes(_rank_main, args=(world, str(tmp), job, init),
                              nprocs=world, join=False, start_method="spawn")


def _join(ctx, job, world, tmp):
    """Wait for the ranks (a rank's exception is raised here); returns
    each rank's result."""
    while not ctx.join(timeout=600):
        pass
    return [torch.load(tmp / f"{job}_{r}.pt", weights_only=False)
            for r in range(world)]


def _spawn(job, world, tmp, init="file"):
    return _join(_start(job, world, tmp, init), job, world, tmp)


def _rank_main(rank, world, tmp, job, init):
    torch.set_num_threads(1)
    tmp = Path(tmp)
    if init == "file":
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(tmp / f"{job}.store"), world),
            rank=rank, world_size=world)
        out = JOBS[job](rank, tmp)
    else:
        out = JOBS[job](rank, tmp)
    torch.save(out, tmp / f"{job}_{rank}.pt")
    dist.destroy_process_group()


def _model(sd, train):
    model = SimplePose(num_joints=17, num_layers=18, deconv_dim=(64, 64, 64),
                       device="cpu")
    model.load_state_dict(sd)
    return model.train(train)


def _one_step(model, x, target, mask, valid, sharded_mesh=None):
    """One AdamW step; the plain one the Retrainer takes, or the sharded
    one.  Returns (loss, grads, state after the step)."""
    opt = build_optimizer(model, RCFG, "SimplePose")
    set_lr(opt, LR)
    if sharded_mesh is None:
        out = model(x)
        loss = masked_heatmap_loss(out, target, mask, valid=valid)
        opt.zero_grad()
        loss.backward()
        opt.step()
        loss = loss.detach()
    else:
        loss = build_sharded_train_step(model, opt, sharded_mesh)(
            x, target, mask, valid)[0]
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return float(loss), grads, {k: v.clone()
                                for k, v in model.state_dict().items()}


def _local_count_grads(model, x, target, mask, valid, mesh):
    """The gradient of DDP's scheme: each rank's loss over its own valid
    count, the ranks' gradients averaged."""
    with mesh:
        out = model(x)
    model.zero_grad()
    masked_heatmap_loss(out, target, mask, valid=valid).backward()
    group = mesh.group("data")
    all_reduce_grads(model.parameters(), group)
    n = dist.get_world_size(group)
    return {k: p.grad / n for k, p in model.named_parameters()}


def _job_two(rank, tmp):
    """Every two-rank check in one process group (one spawn)."""
    inp = torch.load(tmp / "inputs.pt", weights_only=False)
    mesh = make_mesh(2, device="cpu")
    out = {"shape": dict(mesh.shape), "axes": mesh.axis_names,
           "coords": mesh.coords,
           "shard": shard_batch({"a": np.arange(24).reshape(8, 3),
                                 "b": [torch.arange(8.)]}, mesh)}
    try:
        shard_batch(np.zeros((7, 3)), mesh)
    except ValueError as e:
        out["shard_odd"] = str(e)

    # the eval step on rank blocks of 8 samples
    model = _model(inp["sd"][0], train=False)
    x8 = torch.from_numpy(inp["x8"])
    hm, emb = build_sharded_eval_step(model, mesh)(
        data_shard(x8, mesh))
    out["eval"] = (hm, emb)

    # the train step, all rows valid and the first 11 valid
    t = inp["train"]
    x, target, mask = (torch.from_numpy(t[k]) for k in ("x", "target",
                                                         "mask"))
    for case, valid in t["valid"].items():
        valid = torch.from_numpy(valid)
        args = [data_shard(a, mesh) for a in (x, target, mask, valid)]
        wrong = _local_count_grads(_model(inp["sd"][0], train=True),
                                   *args, mesh)
        loss, grads, state = _one_step(_model(inp["sd"][0], train=True),
                                       *args,
                                       sharded_mesh=mesh)
        out[f"step_{case}"] = {"loss": loss, "grads": grads, "state": state,
                               "local_count_grads": wrong}

    # Retrainer(mesh=) over 3 epochs, and an odd batch
    ds = build_dataset({"TYPE": "Posetrack21", **inp["video"]})
    frames = ds.load_frames()
    kw = dict(input_size=INPUT, hm_size=HM, aug=AugCfg(**AUG),
              joint_pairs=ds.joint_pairs, seed=9, mesh=mesh, device="cpu")
    model = _model(inp["sd"][5], train=False)
    tr = Retrainer(model, RCFG, "SimplePose", **kw)
    idx = np.arange(len(ds.data))
    wh = (ds.data.width, ds.data.height)
    loss, acc = tr.retrain(ds.data, frames, idx, 3, wh)
    out["retrain"] = (loss, acc, {k: v.clone()
                                  for k, v in model.state_dict().items()})
    odd = Retrainer(_model(inp["sd"][5], train=False),
                    dict(RCFG, BATCH_SIZE=7), "SimplePose", **kw)
    try:
        odd.retrain(ds.data, frames, idx, 1, wh)
    except ValueError as e:
        out["retrain_odd"] = str(e)

    # ScoringEngine(mesh=): chunk 31 -> 30, a ragged last chunk
    engine = ScoringEngine(_model(inp["sd"][3], train=False),
                           ScoringConfig(uncertainty="THC_L1",
                                         need_embedding=True,
                                         input_size=INPUT),
                           chunk=31, device="cpu", mesh=mesh)
    out["chunk"] = engine.chunk
    out["scores"] = _score(engine, inp["scoring"])
    return out


def data_shard(a, mesh):
    return Sharding(mesh, ("data",)).local(a)


def _score(engine, video):
    ds = build_dataset({"TYPE": "Posetrack21", **video})
    d = ds.data
    bbox_ann = np.stack([d.bboxes[:, 0], d.bboxes[:, 1],
                         d.bboxes[:, 2] - d.bboxes[:, 0],
                         d.bboxes[:, 3] - d.bboxes[:, 1]], 1)
    res = engine.score(ds.load_frames(), d.frame_idx, d.bboxes,
                       d.gt_keypoints, bbox_ann, d.is_prev, d.is_next,
                       keep_heatmaps=False)
    return res


def _job_grid(rank, tmp):
    """A ('video', 'data') mesh of 2x2 ranks: each video's samples shard
    over its 'data' subgroup; the forward, and a train-mode BatchNorm
    synced over that subgroup, against the video's unsharded ones."""
    mesh = make_mesh(4, axes=("video", "data"), shape=(2, 2), device="cpu")
    v = mesh.coords["video"]
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.normal(0, 1, (2, 8, 3, 64, 64)).astype(
        np.float32))                                      # (videos, samples)
    feats = torch.from_numpy(rng.normal(0.5, 2, (2, 8, 4, 5, 5)).astype(
        np.float32))
    block = Sharding(mesh, ("video", "data")).local(xs)[0]
    torch.manual_seed(0)
    model = SimplePose(num_joints=17, num_layers=18,
                       deconv_dim=(64, 64, 64), device="cpu").eval()
    with torch.no_grad():
        hm = all_gather(model(block), mesh.group("data"))
        ref = model(xs[v])
    bn, bn_ref = batchnorm(4).train(), batchnorm(4).train()
    with mesh:
        y = all_gather(bn(Sharding(mesh, ("video", "data")).local(feats)[0]),
                       mesh.group("data"))
    y_ref = bn_ref(feats[v])
    return {"coords": mesh.coords, "hm": hm, "ref": ref, "bn": y.detach(),
            "bn_ref": y_ref.detach(),
            "bn_stats": (bn.running_mean, bn.running_var),
            "bn_stats_ref": (bn_ref.running_mean, bn_ref.running_var),
            "group_sizes": {a: dist.get_world_size(mesh.group(a))
                            for a in mesh.axis_names}}


def _job_tcp(rank, tmp):
    port = int((tmp / "port").read_text())
    mesh = init_multihost(f"localhost:{port}", 2, rank, device="cpu")
    return {"world": dist.get_world_size(), "rank": dist.get_rank(),
            "backend": dist.get_backend(), "shape": dict(mesh.shape),
            "axes": mesh.axis_names, "mesh_rank": mesh.rank}


JOBS = {"two": _job_two, "grid": _job_grid, "tcp": _job_tcp}


# ---- the parent's side -----------------------------------------------------
def _cos_norm(a, b):
    a, b = a.double().ravel(), b.double().ravel()
    na, nb = a.norm().item(), b.norm().item()
    cos = (a @ b).item() / (na * nb) if na > 0 and nb > 0 else 1.0
    return cos, na, nb


def _grads_agree(got, want):
    """test_sharding.py:113's gradient bound: per leaf, cosine > 0.9999
    and the norm within rel 1e-2."""
    for k, w in want.items():
        cos, nw, ng = _cos_norm(w, got[k])
        if not (abs(ng - nw) <= 1e-2 * nw and cos > 0.9999):
            return False, (k, cos, nw, ng)
    return True, None


def _rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The runs that need no input from JAX, started at once so that they
    overlap: the 2x2 mesh's four ranks, init_multihost's two and the CLI
    loop under torchrun."""
    import yaml
    from tests.test_torch_al import cfg_dict
    grid, tcp, cli = (tmp_path_factory.mktemp(n) for n in ("grid", "tcp",
                                                           "cli"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    (tcp / "port").write_text(str(port))
    cfg = cfg_dict("", "", "", "")
    cfg["AE"]["EPOCH"] = 1
    cfg["VAL"]["QUERY_RATIO"] = [0.5, 1.0]
    (cli / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    argv = ["--cfg", str(cli / "tiny.yaml"), "--video_id", "000001",
            "--uncertainty", "THC+WPU", "--representativeness", "Influence",
            "--filter", "Coreset", "--continual", "--seedfix", "--synthetic",
            "--from_scratch", "--device", "cpu", "--synth_frames", "3",
            "--synth_persons", "2", "--synth_size", "96", "80"]
    for d in ("dp", "tmpdir", "one"):
        (cli / d).mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(cli / "tmpdir"),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         "vatl4pose_tpu_torch.cli.run_active_learning", "--data_parallel",
         *argv], cwd=cli / "dp", env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    runs = {"grid": (_start("grid", 4, grid), grid),
            "tcp": (_start("tcp", 2, tcp, init="tcp"), tcp),
            "cli": (proc, cli, argv)}
    yield runs
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def two(tmp_path_factory, started):
    """The inputs, the two-rank run and, while it runs, the one-process
    references of the port and the JAX package's mesh runs."""
    import jax
    import jax.numpy as jnp

    from vatl4pose_tpu.config import Cfg
    from vatl4pose_tpu.data.synthetic import make_synthetic_video
    from vatl4pose_tpu.models import build_sppe
    from vatl4pose_tpu_torch.models import state_dict_from_flax

    tmp = tmp_path_factory.mktemp("dp2")
    rng = np.random.default_rng(11)
    preset = Cfg({"IMAGE_SIZE": list(INPUT), "HEATMAP_SIZE": list(HM),
                  "SIGMA": 2, "NUM_JOINTS": 17, "TYPE": "simple"})
    mcfg = Cfg({"TYPE": "SimplePose", "NUM_DECONV_FILTERS": [64, 64, 64],
                "NUM_LAYERS": 18})
    # each check from the weights of the tests/test_sharding.py test that
    # it mirrors: Flax's init under PRNGKey 0 (the steps), 5 (the
    # retrainer) and 3 (the scoring pass)
    init = jax.jit(build_sppe(mcfg, preset, train=True).init)
    variables = {key: jax.tree.map(np.asarray, init(
        jax.random.PRNGKey(key), jnp.zeros((1, 64, 64, 3))))
        for key in (0, 3, 5)}
    sd = {key: state_dict_from_flax(v, "SimplePose")
          for key, v in variables.items()}
    B = 16
    tw = (rng.uniform(size=(B, 17)) > 0.2).astype(np.float32)
    train = {"x": rng.normal(0, 1, (B, 3, 64, 64)).astype(np.float32),
             "target": rng.uniform(0, 1, (B, 17, 16, 16)).astype(np.float32),
             "mask": tw[:, :, None, None],
             "valid": {"even": np.ones(B, bool),
                       "uneven": np.arange(B) < 11}}
    root, ann = make_synthetic_video(str(tmp / "v6"), num_frames=6,
                                     num_persons=2, width=160, height=128)
    sroot, sann = make_synthetic_video(str(tmp / "v20"), num_frames=20,
                                       num_persons=2, width=160, height=128)
    inp = {"sd": sd, "x8": rng.normal(0, 1, (8, 3, 64, 64)).astype(
               np.float32),
           "train": train, "video": {"ROOT": root, "ANN": ann},
           "scoring": {"ROOT": sroot, "ANN": sann}}
    torch.save(inp, tmp / "inputs.pt")
    ctx = _start("two", 2, tmp)

    # the port in one process
    ref = {"eval": _model(sd[0], train=False)(torch.from_numpy(inp["x8"]),
                                              return_embedding=True)}
    for case, valid in train["valid"].items():
        ref[f"step_{case}"] = _one_step(
            _model(sd[0], train=True), *(torch.from_numpy(train[k]) for k in
                                         ("x", "target", "mask")),
            torch.from_numpy(valid))
    ds = build_dataset({"TYPE": "Posetrack21", "ROOT": root, "ANN": ann})
    model = _model(sd[5], train=False)
    tr = Retrainer(model, RCFG, "SimplePose", input_size=INPUT, hm_size=HM,
                   aug=AugCfg(**AUG), joint_pairs=ds.joint_pairs, seed=9,
                   device="cpu")
    loss, acc = tr.retrain(ds.data, ds.load_frames(),
                           np.arange(len(ds.data)), 3,
                           (ds.data.width, ds.data.height))
    ref["retrain"] = (loss, acc, model.state_dict())
    ref["scores"] = _score(ScoringEngine(
        _model(sd[3], train=False), ScoringConfig(
            uncertainty="THC_L1", need_embedding=True, input_size=INPUT),
        chunk=31, device="cpu"), inp["scoring"])
    return {"inp": inp, "ref": ref, "jax": _jax_mesh_runs(inp, variables,
                                                          mcfg, preset),
            "ranks": _join(ctx, "two", 2, tmp)}


def _jax_mesh_runs(inp, variables, mcfg, preset):
    """The JAX package on make_mesh(2) from the same weights and inputs:
    the sharded eval step, the sharded train step's loss, 3 epochs of
    Retrainer(mesh=) and the error of an odd BATCH_SIZE."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from vatl4pose_tpu.config import Cfg
    from vatl4pose_tpu.data.dataset import build_dataset as jax_dataset
    from vatl4pose_tpu.data.pipeline import AugCfg as JaxAug
    from vatl4pose_tpu.models import build_sppe
    from vatl4pose_tpu.parallel.mesh import make_mesh, shard_batch
    from vatl4pose_tpu.parallel.steps import (build_sharded_eval_step,
                                              build_sharded_train_step)
    from vatl4pose_tpu.train.optim import init_state, make_adamw
    from vatl4pose_tpu.train.retrain import Retrainer as JaxRetrainer
    from vatl4pose_tpu_torch.models import state_dict_from_flax

    out = {}
    mesh = make_mesh(2)
    with mesh:
        hm, emb = build_sharded_eval_step(
            build_sppe(mcfg, preset, train=False), mesh)(
            variables[0],
            shard_batch(np.transpose(inp["x8"], (0, 2, 3, 1)), mesh))
    out["eval"] = (np.asarray(hm), np.asarray(emb))

    t = inp["train"]
    bsh = NamedSharding(mesh, P("data"))
    v0 = jax.tree.map(jnp.asarray, variables[0])
    step = build_sharded_train_step(build_sppe(mcfg, preset, train=True),
                                    make_adamw(0.7), lambda k: 1.0, mesh)
    for case, valid in t["valid"].items():
        args = (np.transpose(t["x"], (0, 2, 3, 1)), t["target"],
                t["mask"][:, :, 0, 0], valid)
        with mesh:
            out[f"step_{case}"] = float(step(
                v0, init_state(v0["params"]),
                *(jax.device_put(a, bsh) for a in args), jnp.asarray(LR))[2])

    ds = jax_dataset(Cfg({"TYPE": "Posetrack21", "IMG_PREFIX": "",
                          **inp["video"]}))
    model = build_sppe(mcfg, preset, train=True)
    frames = jax.device_put(ds.load_frames())
    idx = np.arange(len(ds.data))
    wh = (ds.data.width, ds.data.height)
    for bs in (RCFG["BATCH_SIZE"], 7):
        tr = JaxRetrainer(model, dict(RCFG, BATCH_SIZE=bs), "SimplePose",
                          input_size=INPUT, hm_size=HM, aug=JaxAug(**AUG),
                          joint_pairs=ds.joint_pairs, seed=9, mesh=mesh)
        try:
            jvars, _, loss, acc = tr.retrain(
                variables[5], tr.init_opt_state(variables[5]["params"]),
                ds.data, frames, idx, 3, wh)
        except ValueError as e:
            out["retrain_odd"] = str(e)
            continue
        out["retrain"] = (float(loss), float(acc), state_dict_from_flax(
            jax.tree.map(np.asarray, jvars), "SimplePose"))
    return out


def test_make_mesh_and_shard_batch_match_jax(two):
    """make_mesh's shape and axes, and shard_batch's blocks, against JAX's
    shard_batch(x, make_mesh(2)).addressable_shards, exactly; an odd
    leading dim raises as JAX's does."""
    from vatl4pose_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from vatl4pose_tpu.parallel.mesh import shard_batch as jax_shard_batch
    jmesh = jax_make_mesh(2)
    x = np.arange(24).reshape(8, 3)
    shards = jax_shard_batch(x, jmesh).addressable_shards
    for r, got in enumerate(two["ranks"]):
        assert got["shape"] == dict(jmesh.shape) == {"data": 2}
        assert got["axes"] == tuple(jmesh.axis_names) == ("data",)
        assert got["coords"] == {"data": r}
        np.testing.assert_array_equal(got["shard"]["a"],
                                      np.asarray(shards[r].data))
        np.testing.assert_array_equal(got["shard"]["b"][0].numpy(),
                                      np.arange(8.)[4 * r:4 * r + 4])
        assert "divisible by 2" in got["shard_odd"]
    with pytest.raises(ValueError, match="divisible by 2"):
        jax_shard_batch(np.zeros((7, 3)), jmesh)


def test_sharded_eval_step_matches_one_process_and_jax(two):
    """2 ranks, R18 at 64x64, 8 samples: the gathered heatmaps and
    embeddings against the port's one-process forward and JAX's
    build_sharded_eval_step at rtol 2e-4, atol 1e-5
    (tests/test_sharding.py:30)."""
    ref_hm, ref_emb = two["ref"]["eval"]
    jhm, jemb = two["jax"]["eval"]
    for got in two["ranks"]:
        hm, emb = got["eval"]
        for want in (ref_hm.detach().numpy(), jhm):
            np.testing.assert_allclose(hm.numpy(), want, rtol=2e-4,
                                       atol=1e-5)
        for want in (ref_emb.detach().numpy(), jemb):
            np.testing.assert_allclose(emb.numpy(), want, rtol=2e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("case", ["even", "uneven"])
def test_sharded_train_step_matches_one_process_and_jax(two, case):
    """16 samples on 2 ranks, all rows valid or the first 11 (so the ranks
    hold 8 and 3 valid rows).  Against the one-process step: the loss
    within rel 1e-5, every gradient leaf at cosine > 0.9999 with its norm
    within rel 1e-2, the BN running statistics within rel 1e-5
    (tests/test_sharding.py:113), the ranks' parameters bit-identical
    after the step; the loss against JAX's sharded step from the same
    weights within rel 1e-4.  The uneven case exists because a step that
    divides each rank's loss by its own valid count (DDP's gradient mean)
    is right when the counts are equal and wrong when they are not: its
    gradient is checked to miss the bound here."""
    ref_loss, ref_grads, ref_state = two["ref"][f"step_{case}"]
    r0, r1 = (r[f"step_{case}"] for r in two["ranks"])
    assert r0["loss"] == r1["loss"]
    assert r0["loss"] == pytest.approx(ref_loss, rel=1e-5)
    ok, worst = _grads_agree(r0["grads"], ref_grads)
    assert ok, worst
    for k, v in ref_state.items():
        assert torch.equal(r0["state"][k], r1["state"][k]), k
        if "running_" in k:
            assert _rel(r0["state"][k], v) <= 1e-5, k
    ok_wrong, _ = _grads_agree(r0["local_count_grads"], ref_grads)
    assert ok_wrong == (case == "even")
    assert r0["loss"] == pytest.approx(two["jax"][f"step_{case}"], rel=1e-4)


def _retrain_agrees(got, want):
    """tests/test_sharding.py:226's bounds on the parameters and
    statistics after 3 epochs: per leaf the norm within rel 5e-2 (abs
    1e-2), at most 1% of the elements off by more than 5e-2 + 5e-2|a|,
    none by 0.5."""
    for k, a in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        a = a.double().numpy()
        b = got[k].double().numpy()
        assert np.linalg.norm(b) == pytest.approx(np.linalg.norm(a),
                                                  rel=5e-2, abs=1e-2), k
        bad = np.abs(b - a) > 5e-2 + 5e-2 * np.abs(a)
        assert bad.mean() <= 0.01, (k, bad.sum(), bad.size)
        assert np.max(np.abs(b - a)) < 0.5, k


def test_retrainer_mesh_matches_one_process_and_jax(two):
    """Retrainer(mesh=) over 3 epochs (12 samples, batch 8, 6 blocks of 4
    a rank) against the one-process Retrainer and against the JAX
    Retrainer(mesh=make_mesh(2)): loss rel 2e-3, accuracy abs 2e-3 and
    the parameters at tests/test_sharding.py:226's bounds; the ranks end
    bit-identical.  A BATCH_SIZE the mesh does not divide raises in both
    packages, for the same cause."""
    (l0, a0, s0), (l1, a1, s1) = (r["retrain"] for r in two["ranks"])
    assert (l0, a0) == (l1, a1)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    for loss, acc, sd in (two["ref"]["retrain"], two["jax"]["retrain"]):
        assert l0 == pytest.approx(loss, rel=2e-3)
        assert a0 == pytest.approx(acc, abs=2e-3)
        _retrain_agrees(s0, sd)
    assert "divisible by 2" in two["jax"]["retrain_odd"]
    for r in two["ranks"]:
        assert "divisible by 2" in r["retrain_odd"]


def test_scoring_mesh_matches_one_process(two):
    """ScoringEngine(mesh=) with THC_L1 and the embedding, chunk 31 (30 on
    2 ranks: chunks of 30 and 10 over 40 samples), against the
    one-process engine at rtol 2e-4, atol 1e-5
    (tests/test_sharding.py:301), on both ranks."""
    ref = two["ref"]["scores"]
    for r in two["ranks"]:
        assert r["chunk"] == 30
        got = r["scores"]
        assert got["embeddings"].shape == ref["embeddings"].shape \
            == (40, 512)
        for k in ("oks", "unc", "det_score", "gc", "kpts", "embeddings",
                  "bbox_crop"):
            np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, atol=1e-5,
                                       err_msg=k)


def test_video_by_data_mesh(started):
    """Four ranks as a 2x2 ('video', 'data') mesh (tests/test_sharding.py:
    79): each video's 8 samples shard over its 'data' subgroup; the
    gathered forward matches the video's unsharded one, and a train-mode
    BatchNorm synced over the subgroup normalises and updates its
    statistics as one over the video's 8 samples."""
    ctx, tmp = started["grid"]
    ranks = _join(ctx, "grid", 4, tmp)
    for r, got in enumerate(ranks):
        assert got["coords"] == {"video": r // 2, "data": r % 2}
        assert got["group_sizes"] == {"video": 2, "data": 2}
        np.testing.assert_allclose(got["hm"].numpy(), got["ref"].numpy(),
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got["bn"].numpy(), got["bn_ref"].numpy(),
                                   rtol=1e-5, atol=1e-6)
        for a, b in zip(got["bn_stats"], got["bn_stats_ref"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)
    # the two videos' groups are apart: their statistics differ
    assert not torch.equal(ranks[0]["bn_stats"][0], ranks[2]["bn_stats"][0])


def test_init_multihost_over_tcp(started):
    """init_multihost with a tcp:// coordinator, 2 ranks on the CPU: the
    world size and the ranks, gloo, and a one-axis mesh over both."""
    ctx, tmp = started["tcp"]
    for r, got in enumerate(_join(ctx, "tcp", 2, tmp)):
        assert got == {"world": 2, "rank": r, "backend": "gloo",
                       "shape": {"data": 2}, "axes": ("data",),
                       "mesh_rank": r}


def test_cli_loop_under_torchrun(started, monkeypatch):
    """The DUW loop (THC+WPU, Influence, Coreset, continual) through
    `torchrun --standalone --nproc_per_node 2 -m ...run_active_learning
    --data_parallel --device cpu` for 2 rounds on a 6-sample synthetic
    video: one work dir, one synthetic video and one cycle_times.jsonl
    line a cycle (rank 0 alone wrote files), every sample queried once,
    and round 0's scores those of the one-process run at rtol 2e-4, atol
    1e-5."""
    from vatl4pose_tpu_torch.cli import run_active_learning as cli
    proc, tmp, argv = started["cli"]
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    assert "[DP] scoring+retrain sharded over 2 ranks" in out
    assert out.count("Result saved to") == 1
    results = list((tmp / "dp").glob("exp/**/result.json"))
    assert len(results) == 1
    assert len(list((tmp / "tmpdir").glob("vatl_synth_*"))) == 1
    cycles = (results[0].parent / "cycle_times.jsonl").read_text()
    assert len(cycles.splitlines()) == 2 * 2 + 1
    rj = json.loads(results[0].read_text())
    assert rj["percentages"][-1] == 100.0
    assert sorted(q for qs in rj["query_list"].values() for q in qs) \
        == list(range(6))

    monkeypatch.chdir(tmp / "one")
    cli.main(argv)
    (ref,) = list((tmp / "one").glob("exp/**/result.json"))
    want = json.loads(ref.read_text())["uncertaity"]["Round0"]
    got = rj["uncertaity"]["Round0"]
    assert got.keys() == want.keys()
    np.testing.assert_allclose(np.array(list(got.values())),
                               np.array(list(want.values())), rtol=2e-4,
                               atol=1e-5)
