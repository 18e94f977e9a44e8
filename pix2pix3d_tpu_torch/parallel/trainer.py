"""The data-parallel trainer, port of `pix2pix3d_tpu/parallel/trainer.py`
(ref `training_loop.py:349-559`): one process per card over a
`torch.distributed` group, or one card with no group.

One `step` runs the iteration's phases in the JAX package's order: the
cross-view no-grad renders, then Gmain, Greg (every `g_reg_interval` steps),
Dmain (and the w_avg update), Dreg (every `d_reg_interval` steps),
D_semantic main and reg, then the generator EMA.  Phases run eagerly, one
after another: the same math as the JAX package's monolithic and per-phase
programs.

Each phase differentiates its loss with `torch.autograd.grad` with respect
to its own network only (the others' parameters have `requires_grad` off,
as the reference's per-phase `requires_grad_` does), sums the gradient over
the accumulation rounds, multiplies by `gain` (the reg interval for the reg
phases), applies `nan_to_num(nan=0, posinf=1e5, neginf=-1e5)` and takes one
Adam step.  A parameter that a phase does not reach gets a zero gradient,
not None: `torch.optim.Adam` skips None gradients and keeps a step count
per parameter, and optax updates every leaf each phase, so zeros keep both
Adam states equal.

Each phase runs inside a `phase_<name>` profiler range (`cv_prep`, `gmain`,
`greg`, `dmain`, `dreg`, `dsmain`, `dsreg`, `ema`).

With a process group (`process_group=`; `parallel/multihost.py`), each rank
runs the step on its rows of the global batch and its own draws, and the
ranks meet where JAX's `shard_map` step reduces over its mesh axis:
- each phase's gradient, every parameter of the network flattened into one
  buffer per dtype, gets one all-reduce of `grad * gain`, is divided by the
  world size, then goes through `nan_to_num` (JAX `:189-191`, `pmean`);
- the D phase's batch-mean ws is averaged over ranks before the w_avg
  update (`:342-350`);
- the step's stat moments get one all-reduce (`:326-339`, `psum`), so every
  rank returns the global stats.
Gloo has no average, so every mean is a sum divided by the world size, on
every backend.  Each collective runs in a profiler range
(`allreduce_<phase>`, `allreduce_ws_mean`, `allreduce_stats`).  The
parameters, buffers and Adam moments are broadcast from rank 0 after
`init_state` and `load_state_tree`, and then checked equal on every rank
(`replica_checksum`).  Every rank then applies the same update to the same
state, so the replicas stay equal bit for bit; the EMA and `copy_buffers`
run on each rank alike.  With no group the step is the one-card step, with
no collective.

Lazy regularization (ref `training_loop.py:359-373`): each network's Adam
runs at `lr * r` with `betas ** r`, r = I / (I + 1).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .. import bridge
from ..models.triplane import init_parameters, update_w_avg
from ..train.ema import copy_buffers, ema_beta, ema_update
from ..train.loss import blur_size_bucket
from ..utils.profiling import annotate, host_read
from .multihost import all_reduce_max_, all_reduce_sum_, broadcast_


def _lazy_adam(params, lr, betas, eps, reg_interval):
    """Adam with lazy-regularization scaling (ref `training_loop.py:366-372`)."""
    r = 1.0 if reg_interval is None else reg_interval / (reg_interval + 1)
    return torch.optim.Adam(params, lr=lr * r,
                            betas=(betas[0] ** r, betas[1] ** r), eps=eps)


def _set_trainable(active, modules):
    for m in modules:
        if m is not None:
            m.requires_grad_(m is active)


# the integer type of each element width, to read a tensor's bits
_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _by_dtype(tensors):
    """`tensors` in lists of one dtype each, in their order."""
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.values())


def reduce_gradients(grads, gain, group):
    """The phase's gradients as JAX's `pmean(flat * gain)` then `nan_to_num`
    (JAX `parallel/trainer.py:189-191`): one flat buffer per dtype, one
    all-reduce (sum) of `grad * gain`, divided by the world size.  Returns
    views of the flat buffers in the gradients' order and shapes."""
    out = {}
    for part in _by_dtype(grads):
        flat = torch.cat([g.reshape(-1) for g in part]).mul_(gain)
        all_reduce_sum_(flat, group).div_(group.size())
        torch.nan_to_num_(flat, nan=0.0, posinf=1e5, neginf=-1e5)
        for g, v in zip(part, flat.split([g.numel() for g in part])):
            out[id(g)] = v.view_as(g)
    return [out[id(g)] for g in grads]


def mean_over_ranks(tensor, group):
    """`pmean`: the sum over ranks divided by the world size (a new tensor)."""
    return all_reduce_sum_(tensor.clone(), group).div_(group.size())


class Trainer:
    def __init__(self, loss, *, g_lr=0.0025, d_lr=0.002, betas=(0.0, 0.99),
                 eps=1e-8, g_reg_interval=4, d_reg_interval=16,
                 grad_accum_rounds=1, process_group=None):
        self.loss = loss
        self.group = process_group
        self.G = loss.G
        self.D = loss.D
        self.D_semantic = loss.D_semantic
        self.g_reg_interval = g_reg_interval
        self.d_reg_interval = d_reg_interval
        self.grad_accum_rounds = int(grad_accum_rounds)
        self._opt_args = dict(g=(g_lr, betas, eps, g_reg_interval),
                              d=(d_lr, betas, eps, d_reg_interval))
        self.G_ema = copy.deepcopy(self.G).eval().requires_grad_(False)
        if self.loss.lpips is not None:
            self.loss.lpips.requires_grad_(False)
        self._reset_optimizers()

    def _reset_optimizers(self):
        self.opt_g = _lazy_adam(self.G.parameters(), *self._opt_args["g"])
        self.opt_d = _lazy_adam(self.D.parameters(), *self._opt_args["d"])
        self.opt_dsem = (None if self.D_semantic is None else
                         _lazy_adam(self.D_semantic.parameters(),
                                    *self._opt_args["d"]))

    def networks(self):
        """{state key: (module, optimizer or None)} in the JAX state's names."""
        nets = {"G": (self.G, self.opt_g), "D": (self.D, self.opt_d),
                "G_ema": (self.G_ema, None)}
        if self.D_semantic is not None:
            nets["D_semantic"] = (self.D_semantic, self.opt_dsem)
        return nets

    # ------------------------------------------------------------------ init
    def init_state(self, seed=0):
        """Draw G, D and D_semantic (in that order) from
        `torch.Generator().manual_seed(seed)`, copy G into G_ema and start
        fresh optimizers."""
        gen = torch.Generator().manual_seed(seed)
        for m in (self.G, self.D, self.D_semantic):
            if m is not None:
                init_parameters(m, gen)
        self.G_ema.load_state_dict(self.G.state_dict())
        self._reset_optimizers()
        self.sync_replicas()

    # -------------------------------------------------------------- replicas
    def _replicated(self):
        """Every tensor the ranks must hold equal: each network's parameters
        and buffers, and each optimizer's moments."""
        out = []
        for module, opt in self.networks().values():
            out += list(module.state_dict().values())
            if opt is not None:
                for p in module.parameters():
                    st = opt.state.get(p)
                    if st:
                        out += [st["exp_avg"], st["exp_avg_sq"]]
        return out

    def replica_checksum(self):
        """An integer over the bits of the replicated state (the sum of its
        words as integers of their width, in int64) on the networks' device."""
        total = 0
        for t in self._replicated():
            words = t.detach().contiguous().view(-1).view(_WORDS[t.element_size()])
            total = total + words.sum(dtype=torch.int64)
        return total

    @torch.no_grad()
    def sync_replicas(self):
        """With a group: broadcast rank 0's parameters, buffers and Adam
        moments into every rank (one flat buffer per dtype), then check that
        every rank holds the same bits (`replica_checksum`'s largest and
        smallest over the ranks agree).  Raises if they do not."""
        if self.group is None:
            return
        for part in _by_dtype(self._replicated()):
            flat = broadcast_(torch.cat([t.reshape(-1) for t in part]), self.group)
            for t, v in zip(part, flat.split([t.numel() for t in part])):
                t.copy_(v.view_as(t))
        c = self.replica_checksum()
        both = all_reduce_max_(torch.stack([c, -c]), self.group)
        if both[0] != -both[1]:
            raise RuntimeError("the ranks' states differ after the broadcast from "
                               "rank 0")

    # ------------------------------------------------------ state as a tree
    @staticmethod
    def _adam_tree(opt, module):
        """The optimizer's state as optax's `(ScaleByAdamState, EmptyState)`
        `to_state_dict` tree: `count` and `mu`/`nu` over every leaf of the
        module's JAX tree (zeros for buffers, which optax updates with zero
        gradients)."""
        params = dict(module.named_parameters())
        mu, nu, count = {}, {}, 0
        for name, value in module.state_dict().items():
            st = opt.state.get(params[name]) if name in params else None
            if st:
                mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
                count = int(st["step"])
            else:
                mu[name] = nu[name] = torch.zeros_like(value)
        return {"0": {"count": np.asarray(count, np.int32),
                      "mu": bridge.params_to_jax(mu), "nu": bridge.params_to_jax(nu)},
                "1": {}}

    def state_tree(self):
        """The full training state as the JAX trainer's state tree (numpy
        leaves in the JAX layouts): G, D, G_ema, D_semantic and each
        network's optax Adam state under `opt_<name>`."""
        tree = {}
        for key, (module, opt) in self.networks().items():
            tree[key] = bridge.params_to_jax(module)
            if opt is not None:
                tree[f"opt_{key}"] = self._adam_tree(opt, module)
        return tree

    @torch.no_grad()
    def load_state_tree(self, tree):
        """Load a JAX-layout training state (`state_tree`'s form, e.g. from
        `checkpoint.load_checkpoint`) into the networks and optimizers."""
        for key, (module, opt) in self.networks().items():
            module.load_state_dict(bridge.params_from_jax(tree[key]), strict=True)
            if opt is None:
                continue
            adam = tree[f"opt_{key}"]["0"]
            count = int(np.asarray(adam["count"]))
            mu = bridge.params_from_jax(adam["mu"])
            nu = bridge.params_from_jax(adam["nu"])
            opt.state.clear()
            if count == 0:
                continue
            for name, p in module.named_parameters():
                opt.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": mu[name].to(p.device, p.dtype).clone(),
                    "exp_avg_sq": nu[name].to(p.device, p.dtype).clone()}
        self.sync_replicas()

    # ------------------------------------------------------------------ step
    def _phase_update(self, name, loss_fn, module, opt, gain):
        """Gradient over the accumulation rounds (summed) -> x gain -> (with
        a group, the mean over ranks) -> nan_to_num -> one Adam step.
        `loss_fn(r)` sees micro-batch r and returns (loss, aux); aux dicts
        of tensors are summed over rounds."""
        _set_trainable(module, (self.G, self.D, self.D_semantic))
        params = list(module.parameters())
        grads = aux = None
        for r in range(self.grad_accum_rounds):
            loss, aux_r = loss_fn(r)
            g = (torch.autograd.grad(loss, params, allow_unused=True)
                 if loss.requires_grad else [None] * len(params))
            g = [torch.zeros_like(p) if gi is None else gi for p, gi in zip(params, g)]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            aux = aux_r if aux is None else {k: aux[k] + aux_r[k] for k in aux}
            del loss, g
        if self.group is None:
            grads = [torch.nan_to_num(g * gain, nan=0.0, posinf=1e5, neginf=-1e5)
                     for g in grads]
        else:
            with annotate(f"allreduce_{name}"):
                grads = reduce_gradients(grads, gain, self.group)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        for p in params:
            p.grad = None
        _set_trainable(None, (self.G, self.D, self.D_semantic))
        return aux

    def _micro_batch(self, tree, r):
        rounds = self.grad_accum_rounds
        if rounds <= 1:
            return tree
        n = next(iter(tree.values())).shape[0] // rounds
        return {k: v[r * n:(r + 1) * n] for k, v in tree.items()}

    def step(self, batch, gen_z, gen_c, generator, *, step_idx, cur_nimg,
             batch_size, ema_kimg=10, ema_rampup=0.05, aug_p=0.0):
        """One training iteration; returns {stat name: [count, sum, sumsq]}
        (numpy, one transfer from the card, the `sync.stats` read of
        `utils/profiling.host_read`; with a group, summed over the ranks).

        batch: {image [B, H, W, 3], mask [B, H, W, 1], pose [B, 25]} on the
        networks' device (with a group, this rank's rows); gen_z/gen_c: `[4,
        B, ...]` per-phase latents and poses (Gmain, Greg, Dmain, Dsmain),
        this rank's columns; `generator`: the `torch.Generator` of every
        random draw of the step (with a group, this rank's own);
        `batch_size`: the global batch (the EMA's); `aug_p`: the
        augmentation probability of Gmain and every D phase (used only with
        the loss's `augment_pipe`)."""
        loss = self.loss
        rounds = self.grad_accum_rounds
        nb = batch["pose"].shape[0]
        if nb % rounds or nb < rounds:
            raise ValueError(f"batch {nb} does not divide into {rounds} "
                             "accumulation rounds")
        sched = loss.schedule(cur_nimg)
        nrr = sched["neural_rendering_resolution"]
        raw_fade = sched["raw_fade"]
        blur_size = blur_size_bucket(sched["blur_sigma"])
        blur = (sched["blur_sigma"], blur_size) if blur_size > 0 else 0.0
        do_greg = (self.g_reg_interval is not None
                   and step_idx % self.g_reg_interval == 0)
        do_dreg = (self.d_reg_interval is not None
                   and step_idx % self.d_reg_interval == 0)
        phase_in = [{"z": gen_z[i], "c": gen_c[i]} for i in range(4)]
        mb = self._micro_batch
        stats = {}

        def add(d):
            for k, v in d.items():
                stats[k] = stats[k] + v if k in stats else v

        cv_aux = None
        if loss.lambda_cross_view > 0:
            with annotate("phase_cv_prep"):
                outs = [loss.cross_view_prep(mb(phase_in[0], r)["z"], mb(batch, r),
                                             mb(phase_in[0], r)["c"], generator, nrr)
                        for r in range(rounds)]
                cv_aux = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

        with annotate("phase_gmain"):
            def gmain(r):
                b, p = mb(batch, r), mb(phase_in[0], r)
                kw = {} if cv_aux is None else {"cv_aux": mb(cv_aux, r)}
                return loss.g_main(b, p["z"], p["c"], generator, blur, nrr,
                                   aug_p=aug_p, raw_fade=raw_fade, **kw)
            add(self._phase_update("gmain", gmain, self.G, self.opt_g, 1.0))

        if do_greg:
            with annotate("phase_greg"):
                def greg(r):
                    return loss.g_reg(mb(batch, r), mb(phase_in[1], r)["z"], generator)
                add(self._phase_update("greg", greg, self.G, self.opt_g,
                                       float(self.g_reg_interval)))

        with annotate("phase_dmain"):
            def dmain(r):
                b, p = mb(batch, r), mb(phase_in[2], r)
                value, (s, aux) = loss.d_main(b, p["z"], p["c"], generator, blur,
                                              nrr, aug_p=aug_p, raw_fade=raw_fade)
                return value, dict(s, _ws_mean=aux["ws"].mean(dim=0) / rounds)
            s = self._phase_update("dmain", dmain, self.D, self.opt_d, 1.0)
            ws_mean = s.pop("_ws_mean")
            if self.group is not None:
                with annotate("allreduce_ws_mean"):
                    ws_mean = mean_over_ranks(ws_mean, self.group)
            update_w_avg(self.G, ws_mean)
            add(s)

        if do_dreg and loss.r1_gamma > 0:
            with annotate("phase_dreg"):
                def dreg(r):
                    return loss.d_r1(mb(batch, r), generator, blur, nrr,
                                     aug_p=aug_p, raw_fade=raw_fade)
                add(self._phase_update("dreg", dreg, self.D, self.opt_d,
                                       float(self.d_reg_interval)))

        if self.D_semantic is not None:
            with annotate("phase_dsmain"):
                def dsmain(r):
                    b, p = mb(batch, r), mb(phase_in[3], r)
                    return loss.d_semantic_main(b, p["z"], p["c"], generator, blur,
                                                nrr, aug_p=aug_p, raw_fade=raw_fade)
                add(self._phase_update("dsmain", dsmain, self.D_semantic, self.opt_dsem, 1.0))
            if do_dreg and loss.r1_gamma > 0:
                with annotate("phase_dsreg"):
                    def dsreg(r):
                        return loss.d_semantic_r1(mb(batch, r), generator, blur, nrr,
                                                  aug_p=aug_p, raw_fade=raw_fade)
                    add(self._phase_update("dsreg", dsreg, self.D_semantic, self.opt_dsem,
                                           float(self.d_reg_interval)))

        with annotate("phase_ema"):
            beta = ema_beta(batch_size, cur_nimg, ema_kimg, ema_rampup)
            ema_update(self.G_ema, self.G, beta)
            copy_buffers(self.G_ema, self.G)

        names = sorted(stats)
        if not names:
            return {}
        flat = torch.stack([stats[k] for k in names])
        if self.group is not None:
            with annotate("allreduce_stats"):
                all_reduce_sum_(flat, self.group)
        flat = np.asarray(host_read(flat, "stats"), dtype=np.float32)
        return dict(zip(names, flat))
