"""One process of `test_torch_port_dist.py`'s two-process train step, on `gloo`.

Run as `python tests/torch_port_dist_child.py DIR` with a torchrun-style
environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). It reads
DIR/inputs.pt, written by the test: the weights, the global batches of two
steps, the drop masks at the global batch's shapes, and the parent's
one-process run's proposal picks and matchings. It takes its rows of each and
runs, on the CPU through `lwdetr_tpu_torch.main`'s pieces:

* run A: two train steps of the unsharded state under DDP, the masks fed
  through `drop.RankRows(drop.Fed(global masks))`: each step's loss and loss
  components (this process's), the gradients before clipping (DDP-averaged),
  the BatchNorm running statistics after each step; the parameters, the EMA
  and the optimizer state after the two steps;
* run B: the same with ZeRO-1 (`shard_opt_state=True`): the parameters and the
  gathered EMA and optimizer state, the bytes of optimizer state held; then a
  checkpoint saved (rank 0 writes) and restored into a fresh sharded state;
* run C: one step whose masks the engine draws itself (`drop.Bernoulli` from
  the step's generator, this process's rows of the global draw), recorded.

It writes DIR/rank<r>.pt and prints one JSON line.
"""
import json
import os
import sys
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lwdetr_tpu_torch.models import criterion as cm  # noqa: E402
from lwdetr_tpu_torch.models import drop  # noqa: E402
from lwdetr_tpu_torch.models import transformer as ttr  # noqa: E402
from lwdetr_tpu_torch.parallel import dist as pdist  # noqa: E402
from lwdetr_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from lwdetr_tpu_torch.train import engine, optim  # noqa: E402


def _rows(x, rank, n):
    return x[rank * n:(rank + 1) * n]


def main():
    out_dir = sys.argv[1]
    rank, world = pdist.init_distributed("cpu")
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    cfg, tcfg = inp["cfg"], inp["tcfg"]
    n = inp["batches"][0]["images"].shape[0] // world
    batches = [{k: _rows(torch.from_numpy(v), rank, n) for k, v in b.items()}
               for b in inp["batches"]]
    picks = iter([])
    matchings = iter([])

    def replay_picks(scores, k):
        return _rows(next(picks), rank, n)

    def replay_matching(*args, **kwargs):
        return next(matchings)[:, rank * n:(rank + 1) * n]

    grads = []
    clip = torch.nn.utils.clip_grad_norm_

    def spy_clip(params, max_norm):
        grads.append({name: p.grad.clone() for name, p in named if p.grad is not None})
        return clip(params, max_norm)

    def run(shard, mask_source, steps):
        nonlocal picks, matchings, named
        picks, matchings = iter(inp["picks"]), iter(inp["matchings"])
        state = engine.create_train_state(cfg, tcfg, niter_per_ep=10, device="cpu",
                                          state_dict=inp["sd"], shard_opt_state=shard)
        named = list(state.model.named_parameters())
        step = engine.build_train_step(state, cm.SetCriterion(cfg, tcfg), tcfg)
        records = []
        grads.clear()
        with mock.patch.object(ttr, "select_proposals", replay_picks), \
                mock.patch.object(cm, "hungarian_match", replay_matching), \
                mock.patch.object(torch.nn.utils, "clip_grad_norm_", spy_clip):
            for i in range(steps):
                metrics = step(batches[i], inp["drop_path"], inp["dropout"], mask_source)
                records.append({
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "bn": {k: v.clone() for k, v in state.model.state_dict().items()
                           if k.endswith(("running_mean", "running_var"))}})
        for r, g in zip(records, grads):
            r["grads"] = g
        return state, records

    named = []
    fed = drop.RankRows(drop.Fed(inp["masks"]), rank, world)
    state_a, rec_a = run(False, fed, 2)
    result = {"rank": rank, "world": world, "steps": rec_a,
              "params_a": {k: v.clone() for k, v in state_a.model.state_dict().items()},
              "ema_a": {k: v.clone() for k, v in state_a.ema.items()},
              "opt_a": state_a.optimizer.state_dict(),
              "opt_bytes_a": optim.state_bytes(state_a.optimizer),
              "ddp": type(state_a.ddp).__name__,
              "fed_used": fed.source.used}

    fed = drop.RankRows(drop.Fed(inp["masks"]), rank, world)
    state_b, rec_b = run(True, fed, 2)
    result.update({
        "steps_b": rec_b, "planned": sorted(state_b.shards),
        "params_b": {k: v.clone() for k, v in state_b.model.state_dict().items()},
        "ema_b": optim.ema_full(state_b.ema, state_b.shards),
        "opt_b": state_b.optimizer.state_dict(),
        "opt_bytes_b": optim.state_bytes(state_b.optimizer)})

    # the sharded state's checkpoint: gathered, written by rank 0, each rank's slices restored
    path = ckpt.save_checkpoint(os.path.join(out_dir, "ckpt"), 2, state_b, epoch=0)
    torch.distributed.barrier()
    saved = torch.load(path, weights_only=False)
    state_c = engine.create_train_state(cfg, tcfg, niter_per_ep=10, device="cpu",
                                        state_dict=inp["sd"], shard_opt_state=True)
    ckpt.restore_checkpoint(path, state_c)
    result.update({
        "saved_opt": saved["optimizer"], "saved_ema": saved["ema_model"],
        "restored_ema_slices_equal": all(torch.equal(state_c.ema[k], state_b.ema[k])
                                         for k in state_b.ema),
        "restored_opt": state_c.optimizer.state_dict(), "restored_step": state_c.step,
        "written_by": sorted(os.listdir(os.path.join(out_dir, "ckpt")))})

    drawn = []
    call = drop.RankRows.__call__

    def record(self, keep, shape, like):
        drawn.append(call(self, keep, shape, like).clone())
        return drawn[-1]

    with mock.patch.object(drop.RankRows, "__call__", record):
        run(False, None, 1)
    result["drawn_masks"] = drawn
    # the stop flag's reduction on the host group: set on rank 1 only
    result["any_process"] = [pdist.any_process(rank == 1), pdist.any_process(False)]

    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    print(json.dumps({"rank": rank, "world": world, "planned": len(state_b.shards),
                      "opt_bytes": [result["opt_bytes_a"], result["opt_bytes_b"]]}))
    pdist.shutdown()


if __name__ == "__main__":
    main()
