"""The PyTorch port on several GPUs of one host, one process per GPU.

    torchrun --nproc-per-node 4 tools/multigpu_check.py [--seed N]
    torchrun --nproc-per-node 4 tools/multigpu_check.py --cpu   # rehearsal
    torchrun --nproc-per-node 1 tools/multigpu_check.py --parts fsdp_ab

Every process joins torchrun's group (``parallel/distributed.py``: NCCL on
the cards, gloo with ``--cpu``, where the tiny model of the CPU tests
stands in for the full-width one) and runs:
1. spatial: a seeded stream (written by process 0 with the port's own
   programs, ``chip_smoke.write_synthetic_stream``) decoded whole by every
   process and split by rows over all of them (``parallel/spatial.py``,
   tensor = world): the split image within ``chip_smoke``'s BATCH_* limits
   of the whole one on every rank; host walls of three decodes of each
   after a first call;
2. data: seeded images through ``encode_batch`` and ``decode_batch`` over
   a data axis of the world: every stream a rank wrote decodes to its
   plan bit for bit; the wall of both calls;
3. stage I: ``train.trainer.main`` on configs/train_stage1.yaml as
   shipped but for one resolution (512², the yaml's batch 8 split over the
   world), a seeded random LPIPS file and seeded PNGs: FSDP2 over the
   world, STEPS steps with a checkpoint at SAVE, then ``--resume`` in a
   fresh trainer that runs the last step again: its state (gathered
   whole) equals the first run's bit for bit; s/step (the steps before
   the checkpoint as ``warm_s``, the first one left out), each rank's peak
   memory, the checkpoint's bytes and seconds.
``--parts fsdp_ab`` (alone, or with the others) instead times the same
stage-I step, built by ``train.trainer.Trainer`` in turn as ``plain``
(the yaml with ``fsdp: false``: the model itself at world 1, DDP above),
``plain_nchw`` (the same with the trainable weights laid out contiguous,
as FSDP lays them out) and ``fsdp`` (the yaml as shipped), AB_ROUNDS
rounds of AB_STEPS steps after a first one each; s/step and peak memory.
Process 0 prints one JSON object and, last, the card line.
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

STEPS = 6
SAVE = 5  # the step after the checkpoint's save times the save too
AB_ROUNDS = 2
AB_STEPS = 3
PARTS = ("spatial", "data", "stage1", "fsdp_ab")
CARD = dict(spatial=1024, data=768, images=8, train=512)
CPU = dict(spatial=256, data=128, images=4, train=128)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _walls(fn, device, n: int = 3):
    """Host ms of ``n`` calls of ``fn`` after a first one, each to a
    synchronised device; (the last call's result, the walls)."""
    out = fn()
    walls = []
    for _ in range(n):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    return out, walls


def _from_zero(obj):
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _model(cpu: bool, seed: int, **kw):
    from __graft_entry__ import _tiny_cfg
    from onedc_tpu_torch.models.onedc import OneDC

    cfg = _tiny_cfg() if cpu else {}
    with torch.device("cpu" if cpu else "cuda"):
        model = OneDC(**cfg, **kw)
    cs.init_random_weights(model, seed)
    return model


def spatial_part(model, device, dtype, size: int, seed: int) -> dict:
    from onedc_tpu_torch.models.onedc import OneDCRuntime
    from onedc_tpu_torch.parallel.mesh import make_mesh
    from onedc_tpu_torch.parallel.spatial import enable_spatial_decode

    whole = OneDCRuntime(model, dtype=dtype, device=device)
    stream = None
    if dist.get_rank() == 0:
        stream = cs.write_synthetic_stream(whole, size, size, seed)[0]
    stream = _from_zero(stream)
    want, whole_ms = _walls(lambda: whole.decode(stream), device)
    bands = make_mesh(device.type, data=1, tensor=dist.get_world_size())
    split = enable_spatial_decode(
        OneDCRuntime(model, dtype=dtype, device=device), bands)
    got, split_ms = _walls(lambda: split.decode(stream), device)
    diff = (got - want).float()
    rel_l2 = (diff.norm() / want.float().norm()).item()
    rel_max = (diff.abs().max() / want.abs().max()).item()
    if not (rel_l2 <= cs.BATCH_REL_L2_TOL and rel_max <= cs.BATCH_MAX_TOL):
        raise AssertionError(f"rank {dist.get_rank()}: the split decode is "
                             f"{rel_l2:.3e} / {rel_max:.3e} from the whole")
    return dict(size=size, bands=dist.get_world_size(), rel_l2=rel_l2,
                rel_max=rel_max, whole_ms=whole_ms, split_ms=split_ms)


def data_part(model, device, dtype, size: int, n: int, seed: int) -> dict:
    from onedc_tpu_torch.models.onedc import OneDCRuntime
    from onedc_tpu_torch.parallel.mesh import make_mesh, rank_rows, real_rows

    rt = OneDCRuntime(model, dtype=dtype, device=device)
    data = make_mesh(device.type, data=dist.get_world_size(), tensor=1)
    images = next(cs.synthetic_batches(seed, n, size))["image"]
    rt.decode_batch([s for s, _ in rt.encode_batch(images[:1])])  # warm
    _sync(device)
    t0 = time.perf_counter()
    streams = [s for s, _ in rt.encode_batch(images, mesh=data)]
    _sync(device)
    encode_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    decoded = rt.decode_batch(streams, mesh=data)
    _sync(device)
    decode_ms = (time.perf_counter() - t0) * 1e3
    if len(decoded) != n or any(not torch.isfinite(d).all()
                                for d in decoded):
        raise AssertionError("decode_batch over the data axis failed")
    rows = rank_rows(n, data)
    plan = rt.write_plan(images[rows])
    for j in range(real_rows(n, data)):
        cs.check_stream_decodes_to_plan(rt, streams[rows[j]], plan, j,
                                        f"row {rows[j]}")
    return dict(size=size, images=n, encode_ms=encode_ms,
                decode_ms=decode_ms)


def _stage1_files(cpu: bool, size: int, seed: int):
    """(a shared temporary directory with seeded training PNGs and a
    seeded LPIPS file, the overrides of configs/train_stage1.yaml that
    point at them and run STEPS steps at ``size``)."""
    from onedc_tpu_torch.data.images import save_image
    from onedc_tpu_torch.nn.lpips import random_lpips_weights
    from onedc_tpu_torch.utils.safetensors import save_safetensors

    tmp = _from_zero(tempfile.mkdtemp(prefix="onedc_multigpu_")
                     if dist.get_rank() == 0 else None)
    tmp = Path(tmp)
    if dist.get_rank() == 0:
        (tmp / "train").mkdir()
        rng = np.random.default_rng(seed)
        for i in range(8):
            img = next(cs.synthetic_batches(int(rng.integers(1 << 30)), 1,
                                            size + 64))["image"][0]
            save_image(img, tmp / "train" / f"train{i}.png")
        save_safetensors(random_lpips_weights(seed),
                         tmp / "lpips.safetensors")
    dist.barrier()
    overrides = dict(resolutions=[size], batch_scales=[1.0],
                     lpips_weights=str(tmp / "lpips.safetensors"),
                     train_data=str(tmp / "train"), eval_data=None,
                     run_dir=str(tmp / "run"), total_steps=STEPS,
                     save_interval=SAVE, log_interval=1, max_checkpoint=1)
    if cpu:
        from __graft_entry__ import _tiny_cfg
        overrides.update({f"model.{k}": list(v) if isinstance(v, tuple)
                          else v for k, v in _tiny_cfg().items()})
        overrides.update({"model.codeformer_window": 4,
                          "model.vqgan_hidden": 32, "device": "cpu"})
    return tmp, overrides


def _argv(overrides: dict) -> list:
    return ["--config", str(ROOT / "configs" / "train_stage1.yaml")] + [
        f"{k}={json.dumps(v)}" for k, v in overrides.items()]


def _cleanup(tmp: Path) -> None:
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(tmp)


def stage1_part(cpu: bool, size: int, seed: int) -> dict:
    from onedc_tpu_torch.train import trainer as tr
    from onedc_tpu_torch.utils.logging import read_metrics

    tmp, overrides = _stage1_files(cpu, size, seed)
    argv = _argv(overrides)
    try:
        if not cpu:
            torch.cuda.reset_peak_memory_stats()
        first = tr.main(argv)
        peak = (0.0 if cpu else torch.cuda.max_memory_allocated() / 2 ** 30)
        if not first.cfg["fsdp"]:
            raise AssertionError("the yaml's fsdp is off")
        want, meta = cs._host_state(first)
        del first
        resumed = tr.main(argv + ["--resume"])
        got, got_meta = cs._host_state(resumed)
        del resumed
        moved = [k for k in want if not torch.equal(got[k], want[k])]
        if moved or got_meta != meta:
            raise AssertionError(f"the resumed state differs: {moved[:4]}")
        rows = read_metrics(tmp / "run") if dist.get_rank() == 0 else []
    finally:
        _cleanup(tmp)
    steps = [r["train/sec_per_step"] for r in rows if "train/sec_per_step"
             in r]
    save = next((r for r in rows if "checkpoint/save_s" in r), {})
    restore = next((r for r in rows if "checkpoint/restore_s" in r), {})
    return dict(size=size, batch=8, s_per_step=steps, warm_s=steps[1:SAVE],
                peak_gib=peak,
                tensors=len(want), checkpoint_bytes=save.get(
                    "checkpoint/bytes"), save_s=save.get("checkpoint/save_s"),
                restore_s=restore.get("checkpoint/restore_s"))


def fsdp_ab_part(cpu: bool, size: int, seed: int) -> dict:
    from onedc_tpu_torch.config import load_config
    from onedc_tpu_torch.parallel.fsdp import spec_for
    from onedc_tpu_torch.train import trainer as tr

    tmp, overrides = _stage1_files(cpu, size, seed)
    device = torch.device("cpu") if cpu else torch.device("cuda")
    out = {name: dict(s_per_step=[], peak_gib=[])
           for name in ("plain", "plain_nchw", "fsdp")}
    try:
        for _ in range(AB_ROUNDS):
            for name, times in out.items():
                argv = _argv(overrides)
                cfg = load_config(argv[1], argv[2:])
                cfg["fsdp"] = name == "fsdp"
                trainer = tr.Trainer(cfg)
                if name == "plain_nchw":
                    with torch.no_grad():
                        for key, p in trainer.model.named_parameters():
                            if (key.split(".")[0] not in trainer.frozen
                                    and spec_for(tuple(p.shape), 1)
                                    is not None):
                                p.data = p.data.contiguous()
                if not cpu:
                    torch.cuda.reset_peak_memory_stats()
                for step in range(AB_STEPS + 1):
                    _sync(device)
                    t0 = time.perf_counter()
                    trainer.train_one_step(step)
                    _sync(device)
                    if step:
                        times["s_per_step"].append(time.perf_counter() - t0)
                if not cpu:
                    times["peak_gib"].append(
                        torch.cuda.max_memory_allocated() / 2 ** 30)
                del trainer
                gc.collect()
                if not cpu:
                    torch.cuda.empty_cache()
    finally:
        _cleanup(tmp)
    return dict(size=size, batch=8, **out)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--parts", default="spatial,data,stage1",
                        help=f"a comma list of {', '.join(PARTS)}")
    args = parser.parse_args()
    parts = args.parts.split(",")
    if set(parts) - set(PARTS):
        parser.error(f"--parts: not one of {PARTS}: {args.parts}")

    from onedc_tpu_torch.parallel import distributed

    if not args.cpu and not torch.cuda.is_available():
        print("multigpu_check: no CUDA device", file=sys.stderr)
        return 1
    distributed.initialize(backend="gloo" if args.cpu else "nccl")
    if not dist.is_initialized():
        print("multigpu_check: run it under torchrun", file=sys.stderr)
        return 1
    rank, world = dist.get_rank(), dist.get_world_size()
    device = torch.device("cpu") if args.cpu else torch.device(
        "cuda", torch.cuda.current_device())
    sizes = CPU if args.cpu else CARD
    if not args.cpu and rank == 0:
        from onedc_tpu_torch.ops import build
        build.build_all()  # one process builds, the others load
    dist.barrier()
    from onedc_tpu_torch.utils.numerics import pinned_numerics

    out = dict(world=world, backend=dist.get_backend())
    t0 = time.perf_counter()
    with pinned_numerics():
        dtype = torch.float32 if args.cpu else torch.bfloat16
        if "spatial" in parts or "data" in parts:
            model = _model(args.cpu, args.seed)
            if "spatial" in parts:
                out["spatial"] = spatial_part(model, device, dtype,
                                              sizes["spatial"], args.seed + 1)
            if "data" in parts:
                out["data"] = data_part(model, device, dtype, sizes["data"],
                                        sizes["images"], args.seed + 2)
            del model
            if not args.cpu:
                torch.cuda.empty_cache()
        if "stage1" in parts:
            out["stage1"] = stage1_part(args.cpu, sizes["train"],
                                        args.seed + 3)
        if "fsdp_ab" in parts:
            out["fsdp_ab"] = fsdp_ab_part(args.cpu, sizes["train"],
                                          args.seed + 3)
    out["wall_s"] = time.perf_counter() - t0
    parts = [None] * world
    dist.all_gather_object(parts, out)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        card = "cpu" if args.cpu else cs.card_line()
        print(json.dumps(dict(ranks=parts, card=card)), flush=True)
        print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
