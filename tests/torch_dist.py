"""Several gloo processes on the CPU for the port's multi-process tests
(``tests/test_torch_dist*.py``); no JAX here, so a spawned process starts
in seconds.

``spawn(fn, world, tmp, *args)`` runs ``fn(rank, *args)`` in ``world``
fresh processes joined by ``torch.distributed`` (gloo, a file rendezvous
under ``tmp``: no port is taken, so parallel test workers cannot collide)
and returns their results in rank order. A process that raises fails the
call with its traceback; so does one that outlives ``timeout``.
"""

from __future__ import annotations

import pickle
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

TIMEOUT_S = 600


def _entry(fn, rank: int, world: int, tmp: str, args) -> None:
    out = Path(tmp) / f"rank{rank}"
    try:
        torch.set_num_threads(1)
        from onedc_tpu_torch.parallel import distributed

        distributed.initialize(f"file://{tmp}/rendezvous", world, rank,
                               backend="gloo")
        result = fn(rank, *args)
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
        with open(out.with_suffix(".pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        out.with_suffix(".err").write_text(traceback.format_exc())
        raise


def spawn(fn, world: int, tmp, *args, timeout: float = TIMEOUT_S) -> list:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each in its own
    process of a ``world``-rank gloo group."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(tmp), args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    errors = [(tmp / f"rank{r}.err") for r in range(world)]
    errors = [e.read_text() for e in errors if e.exists()]
    if errors or alive or any(p.exitcode for p in procs):
        raise RuntimeError(f"spawned ranks failed (exit codes "
                           f"{[p.exitcode for p in procs]}, "
                           f"{len(alive)} timed out):\n" + "\n".join(errors))
    results = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def to_numpy(tensors: dict) -> dict:
    """{name: numpy} of tensors, DTensors gathered whole (every rank)."""
    from torch.distributed.tensor import DTensor

    out = {}
    for k in sorted(tensors):
        t = tensors[k]
        if t is None:
            continue
        if isinstance(t, DTensor):
            t = t.full_tensor()
        out[k] = t.detach().float().numpy().copy()
    return out


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


# -- the workers of the test files (importable by a spawned process) -------

def utilities(rank: int) -> dict:
    """``parallel/distributed.py`` on a live group."""
    from onedc_tpu_torch.parallel import distributed as d

    d.initialize("file:///nonexistent/never-read", 2, rank)  # a no-op
    d.sync_global_devices("test")
    return dict(world=d.world_size(), rank=d.rank(),
                main=d.is_main_process(),
                gathered=d.process_allgather(np.array([rank, 10 + rank])),
                mean=d.reduce_mean_across_hosts({"a": float(rank),
                                                 "b": 2.0 * rank + 1}))


def _train_state(trainer) -> dict:
    return to_numpy({n: p.data for n, p in trainer.model.named_parameters()})


def _plain_update(trainer, before: dict, grads: dict) -> dict:
    """The trainer's optimizer, one fresh copy over plain tensors holding
    ``before`` and ``grads``: the update it computes (params after)."""
    from onedc_tpu_torch.train.step import make_optimizer

    cfg = trainer.cfg
    names = trainer.trainable_names
    params = [torch.nn.Parameter(torch.from_numpy(before[n].copy()))
              for n in names]
    for p, n in zip(params, names):
        p.grad = torch.from_numpy(grads[n].copy())
    opt = make_optimizer(params, lr=float(cfg["lr"]),
                         warmup_steps=int(cfg["warmup_steps"]),
                         grad_clip=float(cfg.get("grad_clip", 5.0)),
                         optimizer=cfg["optimizer"])
    opt.step()
    return {n: p.detach().numpy() for n, p in zip(names, params)}


def one_step(cfg: dict, batch: dict) -> dict:
    """One ``Trainer.train_one_step(0)`` on ``batch``: the metrics, every
    gradient and (over ranks) the largest relative difference of the
    trainable parameters' change from a plain optimizer's on the same
    gradients."""
    from onedc_tpu_torch.parallel.distributed import world_size
    from onedc_tpu_torch.train.trainer import Trainer

    tr = Trainer(cfg, device="cpu", batches=[batch])
    before = _train_state(tr)
    metrics = tr.train_one_step(0)
    grads = to_numpy({n: p.grad for n, p in tr.model.named_parameters()})
    out = dict(metrics=metrics, grads=grads)
    if world_size() > 1:
        after = _train_state(tr)
        want = _plain_update(tr, before, grads)
        out["update_err"] = max(
            rel_err(after[n] - before[n], want[n] - before[n])
            for n in tr.trainable_names)
    return out


def train_scenarios(rank: int, steps: dict, ckpt: dict) -> dict:
    """``one_step`` of each ``steps`` entry (name: (cfg, batch)); then the
    checkpoints: ``ckpt["resume"]`` (argv of ``trainer.main --resume`` on
    a run directory that holds a one-rank checkpoint of its last step)
    resumed over the ranks, its state gathered;
    ``ckpt["save"]`` (argv of ``trainer.main``) trained over the ranks,
    its state gathered at the end."""
    from onedc_tpu_torch.train import trainer as tr

    out = {name: one_step(cfg, batch) for name, (cfg, batch) in
           steps.items()}
    resumed = tr.main(ckpt["resume"])
    out["resumed_step"] = resumed.state.step
    out["resumed"] = to_numpy(resumed.checkpoint_state()[0])
    saver = tr.main(ckpt["save"])
    out["saved"] = to_numpy(saver.checkpoint_state()[0])
    out["saved_meta"] = saver.checkpoint_state()[1]
    return out if rank == 0 else {"rank": rank}


def grain_epoch(rank: int, cfg: dict) -> list:
    """One epoch of ``loader: grain`` through ``Trainer.train_one_step``,
    its step function replaced by a recorder: per step, the (image, noise)
    this rank would train."""
    from onedc_tpu_torch.train.trainer import Trainer

    tr = Trainer(cfg, device="cpu")
    seen = []

    def record(state, batch, noise):
        seen.append((batch["image"].numpy().copy(), noise.numpy().copy()))
        return {}

    tr.step_fn = record
    for step in range(tr.train_iter.batches_per_epoch):
        tr.train_one_step(step)
    tr.train_iter.close()
    return seen


def stage2_runs(rank: int, argvs: list) -> list:
    """``stage2_run`` of each argv in turn."""
    return [stage2_run(rank, argv) for argv in argvs]


def stage2_run(rank: int, argv: list) -> dict:
    """``trainer_stage2.main(argv)``: process 0's metrics rows and every
    gradient left after the run (the generator's of its last turn, the
    critic's of the last step)."""
    from onedc_tpu_torch.train import trainer_stage2 as t2
    from onedc_tpu_torch.utils.logging import read_metrics

    tr = t2.main(argv)
    grads = to_numpy(
        {f"gen/{n}": p.grad for n, p in tr.onedc.named_parameters()}
        | {f"guid/{n}": p.grad for n, p in tr.guidance.named_parameters()})
    if rank:
        return {}
    return dict(rows=read_metrics(tr.cfg["run_dir"]), grads=grads)


def _runtime(state_path: str, **kw):
    from __graft_entry__ import _tiny_cfg
    from onedc_tpu_torch.models.onedc import OneDC, OneDCRuntime

    model = OneDC(**_tiny_cfg(), **kw)
    return OneDCRuntime(model, torch.load(state_path), device="cpu")


def codecs(rank: int, state_path: str, images, streams, z_streams,
           small_stream, tiled_image, tile: int, overlap: int) -> dict:
    """The batch codecs over a data axis of 2 and the spatial decode over a
    tensor axis of 2, on the tiny model of ``state_path``."""
    from onedc_tpu_torch.parallel import spatial
    from onedc_tpu_torch.parallel.mesh import make_mesh
    from onedc_tpu_torch.parallel.tiled import TiledCodec

    out: dict = {}
    data = make_mesh("cpu", data=2, tensor=1)
    rt = _runtime(state_path)
    odd = np.concatenate([images, images[:1]])  # 3 rows: one padding row
    out["encode_batch"] = [bytes(s) for s, _ in rt.encode_batch(odd, data)]
    out["encode_many"] = [bytes(s) for s, _ in rt.encode_many(
        [im[None] for im in odd], mesh=data)]
    out["decode_batch"] = [t.numpy() for t in rt.decode_batch(
        list(streams) + [small_stream, streams[0]], mesh=data)]
    tiled = TiledCodec(rt, tile, overlap, mesh=data)
    out["tiled"], _ = tiled.encode(tiled_image)
    out["tiled_decoded"] = tiled.decode(stream=out["tiled"]).numpy()

    bands = make_mesh("cpu", data=1, tensor=2)
    halos = []
    halo = spatial.Band.halo

    def counted(self, x):
        halos.append(tuple(x.shape))
        return halo(self, x)

    spatial.Band.halo = counted
    try:
        rts = spatial.enable_spatial_decode(_runtime(state_path), bands)
        out["spatial"] = [rts.decode(s).numpy() for s in streams]
        out["spatial_batch"] = [t.numpy() for t in rts.decode_batch(streams)]
        out["halos"] = len(halos)
        out["band_rows"] = sorted({s[2] for s in halos})
        rtz = spatial.enable_spatial_decode(
            _runtime(state_path, z_only=True), bands)
        out["spatial_z"] = [rtz.decode(s).numpy() for s in z_streams]
    finally:
        spatial.Band.halo = halo
    try:
        rts.decode(small_stream)
    except ValueError as err:
        out["small_error"] = str(err)
    return out
