"""The port's multi-rank checks, the counterpart of the reference's
``tests/_distributed_main.py`` (its SNN and pipeline cases; the LM ones
wait for the LM stack), on 4 gloo ranks on the CPU.

    python tests/_torch_distributed_main.py DIR

spawns the ranks with ``torch.multiprocessing``; they meet through a
``file://`` store under DIR.  Rank 0 prints one ``CHECK <name> ok`` or
``CHECK <name> FAIL <why>`` line per check and, last, ``ALL TORCH
DISTRIBUTED CHECKS RAN``; tests/test_torch_distributed.py reads them.
Every rank runs every collective of a check before rank 0 judges it, so
a wrong value fails its check and the next one still runs.
"""
import dataclasses
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
TOL = 1e-6              # the compression and manual-DP replays
DET_TOL = 1e-5          # the detector's data-parallel step vs one process


def _say(name, ok, why=""):
    print(f"CHECK {name} {'ok' if ok else 'FAIL ' + why}", flush=True)


class Checks:
    """Each method runs on every rank; returns None, or on rank 0 a list
    of (name, ok, why)."""

    def __init__(self, rank):
        self.rank = rank
        from repro_torch.distributed.sharding import rank_mesh
        # the (pod, data) = (2, 2) mesh and the flat (data,) = (4,) one;
        # every rank builds both, in the same order
        self.pod_mesh = rank_mesh((2, 2), ("pod", "data"))
        self.flat_mesh = rank_mesh((WORLD,), ("data",))

    # ------------------------------------------------------------------
    def mesh_plumbing(self):
        from repro_torch.distributed.sharding import (axis_index,
                                                      maybe_all_gather,
                                                      maybe_psum)
        from repro_torch.launch.mesh import (make_mesh_for,
                                             make_production_mesh)
        m = self.pod_mesh
        c = m.coords(self.rank)
        got = [axis_index(m.group("data")), axis_index(m.group("pod")),
               axis_index(m.group(("pod", "data")))]
        x = torch.full((2,), float(self.rank))
        s_data = maybe_psum(x, m.group("data"))
        g = maybe_all_gather(x[None], m.group("pod"), 0)
        elastic = make_mesh_for(WORLD)
        try:
            make_production_mesh()
            refused = False
        except ValueError:
            refused = True
        rows = torch.arange(8.0)
        from repro_torch.distributed.sharding import MeshAxes, batch_sharding
        piece = batch_sharding(MeshAxes(m, dp=("pod", "data"))).place(rows)
        pieces = maybe_all_gather(piece, m.group(("pod", "data")), 0)
        ok = (got == [c["data"], c["pod"], self.rank]
              and torch.equal(s_data, torch.full((2,), float(
                  sum(r for r in range(WORLD)
                      if m.coords(r)["pod"] == c["pod"]))))
              and g[:, 0].tolist() == [float(r) for r in range(WORLD)
                                       if m.coords(r)["data"] == c["data"]]
              and tuple(elastic.shape.values()) == (1, WORLD)
              and elastic.axis_names == ("data", "model") and refused
              and torch.equal(pieces, rows))
        oks = maybe_all_gather(torch.tensor([float(ok)]), m.group(
            ("pod", "data")), 0)
        if self.rank == 0:
            return [("mesh_plumbing", bool(oks.all()),
                     f"rank oks {oks.tolist()}")]

    # ------------------------------------------------------------------
    def compressed_psum(self):
        """compressed_psum over the 4 ranks against a numpy replay of
        every rank's quantise, dequantise and sum (a length that is not a
        multiple of 256): the residuals within 1e-6, the sum within 1e-6
        of its largest value."""
        from repro_torch.distributed.compress import compressed_psum
        from repro_torch.distributed.sharding import maybe_all_gather
        group = self.flat_mesh.group("data")

        def x_of(r):
            return np.random.default_rng(100 + r).normal(
                0, 1 + r, (3, 371)).astype(np.float32)
        summed, residual = compressed_psum(torch.from_numpy(x_of(self.rank)),
                                           group)
        sums = maybe_all_gather(summed[None], group, 0)
        resids = maybe_all_gather(residual[None], group, 0)
        if self.rank:
            return None
        deq, res = [], []
        for r in range(WORLD):
            x = x_of(r)
            flat = np.pad(x.reshape(-1), (0, (-x.size) % 256))
            blocks = flat.reshape(-1, 256)
            scale = (np.abs(blocks).max(-1, keepdims=True)
                     / np.float32(127.0)).astype(np.float32)
            q = np.round(blocks / np.maximum(scale, np.float32(1e-12)))
            d = (q.astype(np.float32) * scale).reshape(-1)[:x.size]
            deq.append(d.reshape(x.shape))
            res.append(x - deq[-1])
        want = np.sum(deq, axis=0)
        # float32 sums of values up to ~20 in another order: relative
        e_sum = float(np.abs(sums.numpy() - want[None]).max()
                      / np.abs(want).max())
        e_res = float(np.abs(resids.numpy() - np.stack(res)).max())
        return [("compressed_psum", e_sum <= TOL and e_res <= TOL,
                 f"sum {e_sum:.3g} (relative) residual {e_res:.3g}")]

    # ------------------------------------------------------------------
    def manual_dp(self):
        """make_manual_dp_train_step on reduced spiking-YOLO over (pod,
        data) = (2, 2): six steps' losses finite and falling (reference
        ``_distributed_main.py:110-147``); its first step against a
        one-process replay of the per-shard gradients, pmean over data,
        int8 with error feedback over pod."""
        from repro_torch.configs.registry import reduced_snn
        from repro_torch.core.npu import init_npu
        from repro_torch.core.train import detection_loss, value_and_grad
        from repro_torch.data.synthetic import (make_scene_batch,
                                                stream_generator)
        from repro_torch.distributed.compress import (
            dequantize_int8, make_manual_dp_train_step, quantize_int8)
        from repro_torch.distributed.sharding import (MeshAxes,
                                                      maybe_all_gather,
                                                      tree_map)
        from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                             adamw_update, tree_leaves)
        mesh = self.pod_mesh
        ax = MeshAxes(mesh=mesh, dp=("pod", "data"), tp=None)
        cfg = reduced_snn("spiking_yolo")
        opt = AdamWConfig(lr=2e-3)
        params = init_npu(torch.Generator().manual_seed(0), cfg,
                          device="cpu")

        def loss_fn(p, scene):
            return detection_loss(p, scene, cfg)

        def update(p, g, o):
            return adamw_update(p, g, o, opt)

        def scene_of(i):
            return make_scene_batch(stream_generator(i, 0), batch=8,
                                    height=cfg.height, width=cfg.width,
                                    time_steps=cfg.time_steps, device="cpu")
        step = make_manual_dp_train_step(loss_fn, ax, update)
        p, o = params, adamw_init(params, opt)
        ef = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.bfloat16),
                      params)
        losses, first = [], None
        for i in range(6):
            p, o, ef, m = step(p, o, ef, scene_of(i))
            losses.append(float(m["loss"]))
            if i == 0:
                first = (p, ef)
        # every rank's parameters after step 1, for the equality check
        flat = torch.cat([x.reshape(-1) for _, x in tree_leaves(first[0])])
        every = maybe_all_gather(flat[None], mesh.group(("pod", "data")), 0)
        ef_pod = torch.cat([x.float().reshape(-1)
                            for _, x in tree_leaves(first[1])])
        efs = maybe_all_gather(ef_pod[None], mesh.group(("pod", "data")), 0)
        if self.rank:
            return None
        out = [("manual_dp_losses_fall",
                bool(np.isfinite(losses).all()
                     and min(losses[-2:]) < max(losses[:2])),
                f"losses {losses}")]
        # the replay: shard (pod, data) holds rows 2 * (2 * pod + data)
        scene = scene_of(0)
        per = [[None, None], [None, None]]
        for pod in range(2):
            for d in range(2):
                k = 2 * pod + d
                rows = tree_map(lambda x: x[2 * k:2 * k + 2], scene)
                per[pod][d] = value_and_grad(
                    detection_loss, params, rows, cfg)
        paths = [q for q, _ in tree_leaves(params)]
        g_pod, loss_pod = [], []
        for pod in range(2):
            (l0, _, g0), (l1, _, g1) = per[pod]
            g_pod.append([(a + b) / 2 for (_, a), (_, b)
                          in zip(tree_leaves(g0), tree_leaves(g1))])
            loss_pod.append((l0 + l1) / 2)
        grads, ef0 = [], []
        for j in range(len(paths)):
            deqs = []
            for pod in range(2):
                g = g_pod[pod][j]
                q, s = quantize_int8(g)
                d = dequantize_int8(q, s, g.shape)
                deqs.append(d)
                if pod == 0:
                    ef0.append((g - d).to(torch.bfloat16))
            grads.append((deqs[0] + deqs[1]) / 2)
        from repro_torch.optim.adamw import tree_unflatten
        want, _, _ = adamw_update(params, tree_unflatten(params, grads),
                                  adamw_init(params, opt), opt)
        want_flat = torch.cat([x.reshape(-1) for _, x in tree_leaves(want)])
        e_p = float((every[0] - want_flat).abs().max())
        same = all(torch.equal(every[r], every[0]) for r in range(WORLD))
        want_ef = torch.cat([x.float().reshape(-1) for x in ef0])
        e_ef = float((efs[0] - want_ef).abs().max())
        out.append(("manual_dp_step_replay",
                    e_p <= TOL and e_ef <= TOL and same,
                    f"params {e_p:.3g} ef {e_ef:.3g} ranks equal {same}"))
        return out

    # ------------------------------------------------------------------
    def _detector_run(self, ax, tc, steps):
        from repro_torch.train.detector import (init_detector_state,
                                                make_data_fn,
                                                make_detector_train_step,
                                                replicate_state,
                                                resolve_snn_config, _recipe)
        cfg = resolve_snn_config(tc)
        opt, sched = _recipe(tc)
        state = replicate_state(init_detector_state(
            torch.Generator().manual_seed(tc.seed), cfg, opt, "cpu"), ax)
        step = make_detector_train_step(cfg, opt, sched, ax)
        data = make_data_fn(tc, cfg, ax, "cpu")
        losses = []
        for s in range(steps):
            state, m = step(state, data(s))
            losses.append(float(m["loss"]))
        return state, losses, m

    def detector_dp(self):
        """The detector's data-parallel step (detector_smoke, batch 8, 2
        steps) at world 2 (the data axis of the (2, 2) mesh) and world 4
        within 1e-5 of the one-process step, losses and every state leaf
        (reference ``_distributed_main.py:150-193``), every rank's state
        bit-equal to its group's first rank's."""
        from repro_torch.configs.registry import TRAIN_CONFIGS
        from repro_torch.distributed.sharding import (MeshAxes,
                                                      maybe_all_gather)
        from repro_torch.optim.adamw import tree_leaves
        tc = dataclasses.replace(TRAIN_CONFIGS["detector_smoke"], batch=8)
        runs = {"world2": MeshAxes(self.pod_mesh, dp=("data",)),
                "world4": MeshAxes(self.flat_mesh, dp=("data",))}
        got = {}
        for name, ax in runs.items():
            state, losses, m = self._detector_run(ax, tc, 2)
            flat = torch.cat([x.float().reshape(-1)
                              for _, x in tree_leaves(state)])
            every = maybe_all_gather(flat[None], self.flat_mesh.group(
                "data"), 0)
            got[name] = (every, losses, m)
        if self.rank:
            return None
        ref_state, ref_losses, ref_m = self._detector_run(MeshAxes(), tc, 2)
        ref = torch.cat([x.float().reshape(-1)
                         for _, x in tree_leaves(ref_state)])
        out = []
        for name, (every, losses, m) in got.items():
            e_loss = max(abs(a - b) / abs(b)
                         for a, b in zip(losses, ref_losses))
            e_state = float((every[0] - ref).abs().max())
            e_tel = max(abs(float(m[k]) - float(ref_m[k]))
                        for k in ("sparsity", "tile_skip", "obj", "xy"))
            same = all(torch.equal(every[r], every[0])
                       for r in range(WORLD))
            out.append((f"detector_dp_{name}",
                        e_loss <= DET_TOL and e_state <= DET_TOL
                        and e_tel <= DET_TOL and same,
                        f"loss {e_loss:.3g} state {e_state:.3g} telemetry "
                        f"{e_tel:.3g} ranks equal {same}"))
        return out

    def detector_uneven_boxes(self):
        """A batch whose shards hold different box counts (shard 0 one
        box, the others their draws): the data-parallel loss and
        gradients equal the one-process ones within 1e-5, where the mean
        of the per-shard losses and gradients (per-rank normalisation)
        misses them by more than ten times that."""
        from repro_torch.configs.registry import TRAIN_CONFIGS
        from repro_torch.core.train import detection_loss, value_and_grad
        from repro_torch.distributed.sharding import (MeshAxes,
                                                      maybe_all_gather,
                                                      tree_map)
        from repro_torch.optim.adamw import tree_leaves
        from repro_torch.train.detector import (data_parallel_grads,
                                                init_detector_state,
                                                make_data_fn,
                                                resolve_snn_config,
                                                shard_scene, _recipe)
        tc = dataclasses.replace(TRAIN_CONFIGS["detector_smoke"], batch=8)
        cfg = resolve_snn_config(tc)
        opt, _ = _recipe(tc)
        ax = MeshAxes(self.flat_mesh, dp=("data",))
        scene = make_data_fn(tc, cfg, device="cpu")(5)
        valid = scene.valid.clone()
        valid[0:2] = False
        valid[0, 0] = True                          # shard 0: one box
        scene = scene._replace(valid=valid)
        counts = [int(valid[2 * r:2 * r + 2].sum()) for r in range(WORLD)]
        params = init_detector_state(torch.Generator().manual_seed(0), cfg,
                                     opt, "cpu").params
        loss, _, grads = data_parallel_grads(params, shard_scene(scene, ax),
                                             cfg, ax)
        own, _, own_g = value_and_grad(detection_loss, params,
                                       shard_scene(scene, ax), cfg)
        owns = maybe_all_gather(own[None], self.flat_mesh.group("data"), 0)
        own_g = torch.cat([x.reshape(-1) for _, x in tree_leaves(own_g)])
        own_gs = maybe_all_gather(own_g[None], self.flat_mesh.group("data"),
                                  0)
        g = torch.cat([x.reshape(-1) for _, x in tree_leaves(grads)])
        every = maybe_all_gather(g[None], self.flat_mesh.group("data"), 0)
        if self.rank:
            return None
        ref_loss, _, ref_grads = value_and_grad(detection_loss, params,
                                                scene, cfg)
        ref = torch.cat([x.reshape(-1) for _, x in tree_leaves(ref_grads)])
        e_loss = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        e_grad = float((every[0] - ref).abs().max() / ref.abs().max())
        per_rank = abs(float(owns.mean()) - float(ref_loss)) \
            / abs(float(ref_loss))
        per_rank_g = float((own_gs.mean(0) - ref).abs().max()
                           / ref.abs().max())
        return [("detector_dp_uneven_boxes",
                 len(set(counts)) > 1 and e_loss <= DET_TOL
                 and e_grad <= DET_TOL and per_rank > 10 * DET_TOL
                 and per_rank_g > 10 * DET_TOL,
                 f"boxes a shard {counts}, loss {e_loss:.3g}, grads "
                 f"{e_grad:.3g}; per-rank normalisation off by "
                 f"{per_rank:.3g} (loss), {per_rank_g:.3g} (grads)")]

    def train_detector_dp(self):
        """``train_detector`` with ``shard`` on under the 4-rank group:
        data-parallel, within 1e-5 of the one-process run (per-step
        losses, the final state), every rank's state bit-equal; only rank
        0 writes checkpoints and evaluates; a batch the world does not
        divide is refused."""
        from repro_torch.configs.registry import TRAIN_CONFIGS
        from repro_torch.distributed.sharding import maybe_all_gather
        from repro_torch.optim.adamw import tree_leaves
        from repro_torch.train.detector import train_detector
        tc = dataclasses.replace(TRAIN_CONFIGS["detector_smoke"], steps=3,
                                 eval_batches=1, eval_batch=2,
                                 ckpt_every=2, log_every=10 ** 9)
        from repro_torch.train.detector import make_train_mesh
        try:
            make_train_mesh(dataclasses.replace(tc, batch=6), "cpu")
            odd_refused = False
        except ValueError:
            odd_refused = True
        ckpt = os.path.join(OUT, "ckpt")
        rep = train_detector(tc, ckpt_dir=ckpt, log=lambda _: None,
                             device="cpu")
        flat = torch.cat([x.float().reshape(-1)
                          for _, x in tree_leaves(rep.state)])
        every = maybe_all_gather(flat[None], self.flat_mesh.group("data"), 0)
        if self.rank:
            return None
        one = train_detector(dataclasses.replace(tc, shard=False),
                             log=lambda _: None, device="cpu")
        ref = torch.cat([x.float().reshape(-1)
                         for _, x in tree_leaves(one.state)])
        e_loss = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                     for a, b in zip(rep.history, one.history))
        e_state = float((every[0] - ref).abs().max())
        same = all(torch.equal(every[r], every[0]) for r in range(WORLD))
        written = sorted(os.listdir(ckpt))
        return [("train_detector_dp",
                 e_loss <= DET_TOL and e_state <= DET_TOL and same
                 and written == ["step_000000002", "step_000000003"]
                 and np.isfinite(rep.ap_after) and odd_refused,
                 f"loss {e_loss:.3g} state {e_state:.3g} ranks equal "
                 f"{same} checkpoints {written} batch 6 over 4 ranks "
                 f"refused {odd_refused}")]

    # ------------------------------------------------------------------
    def pipeline(self):
        """pipeline_forward with S = 4 stages, M = 8 microbatches within
        1e-5 of the sequential stages, on every rank; bubble_fraction
        (reference ``_distributed_main.py:196-215``)."""
        from repro_torch.distributed.pipeline_parallel import (
            bubble_fraction, pipeline_forward)
        rng = np.random.default_rng(0)
        S, M, mb, d = WORLD, 8, 2, 16
        Ws = torch.from_numpy(rng.normal(0, 0.3, (S, d, d)).astype(
            np.float32))
        x = torch.from_numpy(rng.normal(0, 1, (M, mb, d)).astype(np.float32))

        def stage(p, h):
            return torch.tanh(h @ p["w"])
        y = pipeline_forward(stage, {"w": Ws}, x,
                             self.flat_mesh.group("data"))
        ref = x
        for s in range(S):
            ref = torch.tanh(ref @ Ws[s])
        err = float((y - ref).abs().max())
        from repro_torch.distributed.sharding import maybe_all_gather
        errs = maybe_all_gather(torch.tensor([err]),
                                self.flat_mesh.group("data"), 0)
        if self.rank:
            return None
        return [("pipeline", float(errs.max()) <= 1e-5
                 and abs(bubble_fraction(4, 8) - 3 / 11) < 1e-9,
                 f"max err over ranks {float(errs.max()):.3g}")]


CHECKS = ("mesh_plumbing", "compressed_psum", "manual_dp", "detector_dp",
          "detector_uneven_boxes", "train_detector_dp", "pipeline")
OUT = None


def worker(rank, out_dir):
    global OUT
    OUT = out_dir
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
        rank=rank, world_size=WORLD)
    try:
        checks = Checks(rank)
        for name in CHECKS:
            try:
                results = getattr(checks, name)()
            except AssertionError:
                results = [(name, False, traceback.format_exc(limit=2))]
            for n, ok, why in results or ():
                _say(n, ok, " ".join(why.split()))
            dist.barrier()
        if rank == 0:
            print("ALL TORCH DISTRIBUTED CHECKS RAN", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    out = sys.argv[1]
    os.makedirs(out, exist_ok=True)
    mp.spawn(worker, args=(out,), nprocs=WORLD, join=True)
