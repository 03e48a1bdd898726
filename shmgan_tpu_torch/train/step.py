"""The fused SHMGAN train step (the counterpart of shmgan_tpu/train/step.py).

One step runs:
  * preprocessing of all V views at once (one launch of the preprocess kernel);
  * the frozen SpecSeg mask from the standardised I90 luma;
  * G1 (target ED) on stopped G params, unless live_g1;
  * ONE live D pass on [generated, ED original] (2B) with injected noise and
    dropout draws;
  * ONE live G pass on the stacked cyclic batch (V*B);
  * ONE D pass on stopped D params over [cyclics, originals] (2*V*B), whose
    inputs still carry gradients;
  * the loss zoo and ONE backward of loss_d + loss_g, where every
    stop_gradient of the JAX step is a .detach();
  * the D update, the G update when epoch >= train_G_after, then the EMA.

G, D and SpecSeg compute in `cfg.model.compute_dtype` (f32 parameters). Their
bf16 outputs meet f32 tensors in concatenations and selects, which promote
to f32 as jnp's do, so preprocessing, the losses, SSIM and the optimizer run
in f32 at either dtype.

Random draws are arguments (`Draws`), so a test can inject the JAX step's;
`sample_draws` reproduces their distributions from a torch.Generator. The
step updates the state in place and returns it with the metrics.

Under a process group (parallel/mesh.py) `views` and `draws` are this
rank's block of the global batch (`Draws.shard` of the global draws by its
data index), and the G and D gradients and the losses are averaged across
the data axis after the backward, before the clip and the optimizers: every
loss is a mean over the batch, so the average of the ranks' means is the
global batch's mean, as in the JAX step on a data-parallel mesh. In a state
cut over the model axis (`state.shard_state`) the M ranks of a data index
take the same rows and draws; the gradients of the cut parameters are
averaged over the data column, and those of whole parameters, with the
losses, over every rank, so the copies on a model row stay equal bit for
bit (`_average_`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from shmgan_tpu_torch.config import Config
from shmgan_tpu_torch.infer import ieee_f32
from shmgan_tpu_torch.ops.color import yuv_to_rgb
from shmgan_tpu_torch.ops.kernels import preprocess
from shmgan_tpu_torch.ops.specprior import specseg_net_input
from shmgan_tpu_torch.ops.ssim import ssim as ssim_fn
from shmgan_tpu_torch.ops.ssim import ssim_log_loss
from shmgan_tpu_torch.ops.standardize import rescale_01_per_image
from shmgan_tpu_torch.parallel import tp
from shmgan_tpu_torch.parallel.mesh import all_reduce_mean_
from shmgan_tpu_torch.train.losses import GanLossInputs, lsgan_to_target, shmgan_losses
from shmgan_tpu_torch.train.state import TrainState, is_model_sharded

REMAT_MODES = ("none", "models", "disc", "gen")


@dataclasses.dataclass
class Draws:
    """One step's random draws."""
    flip: torch.Tensor                   # () bool: flip all views up/down
    t: torch.Tensor                      # () f32: smoothed label t ~ U[low, high]
    drop: torch.Tensor                   # (1, V) or (B, V) f32, 1 = view dropped
    noise: Optional[torch.Tensor] = None  # (2B, 3, H, W) N(0, 1) of D's live pass,
    #                                       rounded to D's compute dtype there
    keep: Optional[torch.Tensor] = None   # (2B, 16N, H/32, W/32) D dropout's keep mask

    def to(self, device) -> "Draws":
        return Draws(**{f.name: None if getattr(self, f.name) is None
                        else getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)})

    def shard(self, rank: int, world: int) -> "Draws":
        """The draws of block `rank` of `world` blocks of a global batch (a
        data index of the data axis), from the global batch's draws: flip
        and t are shared, a (1, V) drop is shared and a (B, V) one is cut by
        rows, and noise and keep, stacked as [generated (B); ED (B)] for D's
        live pass, are cut in each half."""
        if world == 1:
            return self

        def rows(x):
            n = x.shape[0] // world
            return x[rank * n:(rank + 1) * n]

        def halves(x):
            if x is None:
                return None
            b = x.shape[0] // 2
            return torch.cat([rows(x[:b]), rows(x[b:])])

        drop = self.drop if self.drop.shape[0] == 1 else rows(self.drop)
        return Draws(flip=self.flip, t=self.t, drop=drop, noise=halves(self.noise),
                     keep=halves(self.keep))


def sample_draws(cfg: Config, generator: torch.Generator, v: int, b: int, h: int,
                 w: int) -> Draws:
    """Draws with the JAX step's distributions, on the generator's device."""
    dev = generator.device
    tr, m = cfg.train, cfg.model

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    flip = uniform() >= 0.5
    if not cfg.data.flip:
        flip = torch.zeros((), dtype=torch.bool, device=dev)
    t = tr.target_label_low + (tr.target_label_high - tr.target_label_low) * uniform()
    rows = 1 if tr.scalar_channel_dropout else b
    drop = (uniform(rows, v) < tr.randomness).float()
    if tr.single_input_prob > 0.0:
        # some patterns become the single-input one: one polarised view kept
        kept = torch.randint(0, v - 1, (rows,), generator=generator, device=dev)
        single = 1.0 - torch.nn.functional.one_hot(kept, v).float()
        drop = torch.where(uniform(rows, 1) < tr.single_input_prob, single, drop)
    noise = keep = None
    if m.d_input_noise > 0:
        noise = torch.randn((2 * b, 3, h, w), generator=generator, device=dev)
    if m.d_dropout > 0:
        keep = uniform(2 * b, 16 * m.filter_size, h // 32, w // 32) < 1.0 - m.d_dropout
    return Draws(flip=flip, t=t, drop=drop, noise=noise, keep=keep)


def preprocess_views(views: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(V, B, H, W, 3) RGB in [0, 1] -> (standardised YUV (V, B, H, W, 3),
    Y (B, H, W, V), average CbCr (B, H, W, 2)); each image standardised on
    its own, all V*B in one launch."""
    v, b, h, w, _ = views.shape
    flat, _ = preprocess.fused_standardize_yuv(views.reshape(v * b, h, w, 3).contiguous())
    ds_yuv = flat.view(v, b, h, w, 3)
    return ds_yuv, ds_yuv[..., 0].permute(1, 2, 3, 0), ds_yuv[..., 1:].mean(dim=0)


def _onehot_planes(b: int, h: int, w: int, c_dim: int, idx: int, device) -> torch.Tensor:
    planes = torch.zeros((b, h, w, c_dim), dtype=torch.float32, device=device)
    planes[..., idx] = 1.0
    return planes


def _average_(state: TrainState, g_grads: Dict[str, torch.Tensor],
              d_grads: Dict[str, torch.Tensor], metrics: Dict[str, torch.Tensor]) -> None:
    """Average the gradients and losses across the ranks, in place: in a
    state cut over the model axis the cut parameters' over the data column
    and the rest over every rank (a model row's copies are equal, so that
    is their data mean); otherwise all of them over every rank."""
    if not is_model_sharded(state):
        all_reduce_mean_(list(g_grads.values()) + list(d_grads.values())
                         + list(metrics.values()))
        return
    cut, whole = [], list(metrics.values())
    for module, grads in ((state.gen, g_grads), (state.disc, d_grads)):
        dims = tp.sharded_params(module)
        for name, g in grads.items():
            (cut if name in dims else whole).append(g)
    all_reduce_mean_(whole)
    all_reduce_mean_(cut, group=state.layout.data_group)


def make_train_step(cfg: Config, debug_grads: bool = False
                    ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """step(state, views, draws, epoch) -> (state, metrics).

    views: (V, B, H, W, 3) RGB in [0, 1], V == c_dim (I0, I45, I90, I135, ED).
    debug_grads: the metrics also hold the G and D gradients by parameter
    name ("_grads"; whole, gathered over the model axis) and the drop
    pattern ("_drop")."""
    tr = cfg.train
    c_dim = cfg.model.c_dim
    live_g1 = tr.live_g1
    g1_recon_weight = tr.g1_recon_weight if live_g1 else 0.0
    if tr.remat not in REMAT_MODES:
        raise ValueError(f"train.remat must be one of {REMAT_MODES}, got {tr.remat!r}")
    remat_g = tr.remat in ("models", "gen")
    remat_d = tr.remat in ("models", "disc")

    def remat(on, fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if on else fn(*args)

    def step(state: TrainState, views: torch.Tensor, draws: Draws,
             epoch: int) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with ieee_f32(), torch.enable_grad():
            return _step(state, views, draws, epoch)

    def _step(state, views, draws, epoch):
        gen, disc = state.gen, state.disc
        v, b, h, w, _ = views.shape
        dev = views.device
        views = torch.where(draws.flip, views.flip(2), views)
        t = draws.t

        ds_yuv, y_planes, avg_cbcr = preprocess_views(views)
        with torch.no_grad():
            ss_in = specseg_net_input(y_planes[..., 2:3], views[2],
                                      cfg.model.specseg_in_channels)
            mask = state.specseg(ss_in)

        drop = draws.drop
        drop_b = (drop[:, None, None, :] > 0.5).expand(b, h, w, v)
        rand_y = torch.where(drop_b, torch.zeros_like(y_planes), y_planes)
        gen_input = torch.cat([rand_y, _onehot_planes(b, h, w, c_dim, c_dim - 1, dev)], -1)
        views_cmp = yuv_to_rgb(ds_yuv) if tr.consistent_domains else views

        # G1 on stopped G params: its inputs carry no gradient either
        if live_g1:
            gen_y = remat(remat_g, gen, gen_input, mask)
        else:
            with torch.no_grad():
                gen_y = gen(gen_input, mask)
        gen_yuv = torch.cat([gen_y, avg_cbcr], dim=-1)
        gen_rgb = yuv_to_rgb(gen_yuv)

        # live D on [generated, ED original]
        live_in = torch.cat([gen_rgb, views_cmp[v - 1]], dim=0)
        rf_live, lbl_live = remat(remat_d, disc, live_in, torch.cat([mask, mask]),
                                  draws.noise, draws.keep)
        rf_gen, rf_target, lbl_gen = rf_live[:b], rf_live[b:], lbl_live[:b]

        # cyclic inputs: dropped views replaced by the (stopped) G1 output
        cyc_base = torch.where(drop_b, gen_y.detach().expand(b, h, w, v), y_planes)
        cyc_inputs = []
        for i in range(v):
            ych = cyc_base.clone()
            ych[..., i] = 0.0
            cyc_inputs.append(torch.cat([ych, _onehot_planes(b, h, w, c_dim, i, dev)], -1))
        cyc_y = remat(remat_g, gen, torch.cat(cyc_inputs), mask.repeat(v, 1, 1, 1))
        cyc_y = cyc_y.view(v, b, h, w, 1)
        cyc_yuv = torch.cat([cyc_y, avg_cbcr.expand(v, b, h, w, 2)], dim=-1)
        cyc_rgb = yuv_to_rgb(cyc_yuv)

        # D on stopped params over [cyclics, originals (, generated)]
        frozen_parts = [cyc_rgb.reshape(v * b, h, w, 3), views_cmp.reshape(v * b, h, w, 3)]
        if live_g1:
            frozen_parts.append(gen_rgb)
        frozen_in = torch.cat(frozen_parts)
        d_stopped = {k: p.detach() for k, p in disc.named_parameters()}
        rf_frozen, lbl_frozen = remat(
            remat_d, lambda x, m: functional_call(disc, d_stopped, (x, m)),
            frozen_in, mask.repeat(2 * v + int(live_g1), 1, 1, 1))
        rf_shape = rf_frozen.shape[1:]
        L = shmgan_losses(
            GanLossInputs(
                rf_gen=rf_gen, lbl_gen=lbl_gen, rf_target=rf_target,
                rf_cyc=rf_frozen[:v * b].reshape(v, b, *rf_shape),
                lbl_cyc=lbl_frozen[:v * b].reshape(v, b, c_dim),
                rf_orig=rf_frozen[v * b:2 * v * b].reshape(v, b, *rf_shape),
                lbl_orig=lbl_frozen[v * b:2 * v * b].reshape(v, b, c_dim),
                gen_rgb=gen_rgb, cyc_rgb=cyc_rgb, cyc_yuv=cyc_yuv, orig_rgb=views_cmp,
                ds_yuv=ds_yuv, mask=mask, drop=drop, target_label=t),
            image_size=cfg.model.image_size, style_weight=tr.style_weight,
            content_weight=tr.content_weight)

        # L_D: total_D + total_C with every dependency but the live D stopped
        loss_d = (L["D1_cls"] + L["D3_cls"].detach()) / 6.0 \
            + (L["D2_rf_target"] + ((L["D4_rf_cyc"] - L["D2_rf_target"]).detach()
                                    + L["D2_rf_target"])) / 6.0 \
            + 0.5 * L["D4_cls"].detach() + 10.0 * L["NST"].detach() \
            + 10.0 * (L["D4_cls"].detach() + L["NST"].detach())
        # L_G: total_G with the live D1 term swapped for its stopped value
        loss_g = L["total_G"] + (L["D1_rf"].detach() - L["D1_rf"]) / 6.0
        if live_g1:
            adv_g1 = lsgan_to_target(rf_frozen[2 * v * b:], t)
            loss_g = loss_g + (adv_g1 - adv_g1.detach()) / 6.0
            L["G1_adv_frozen"] = adv_g1.detach()
        if g1_recon_weight > 0.0:
            ed_cmp = views_cmp[v - 1] if tr.consistent_domains else yuv_to_rgb(ds_yuv[v - 1])
            g1_l1 = (gen_rgb - ed_cmp).abs().mean()
            s = ssim_fn(rescale_01_per_image(gen_yuv), rescale_01_per_image(ds_yuv[v - 1]),
                        max_val=5.0)
            g1_ssim = ssim_log_loss(s).mean()
            loss_g = loss_g + g1_recon_weight * (g1_l1 + g1_ssim)
            L["G1_L1"], L["G1_SSIM_loss"] = g1_l1, g1_ssim

        g_named, d_named = dict(gen.named_parameters()), dict(disc.named_parameters())
        grads = torch.autograd.grad(loss_d + loss_g,
                                    list(g_named.values()) + list(d_named.values()))
        metrics = {k: val.detach() for k, val in L.items()}
        g_grads = dict(zip(g_named, grads[:len(g_named)]))
        d_grads = dict(zip(d_named, grads[len(g_named):]))
        _average_(state, g_grads, d_grads, metrics)

        state.d_opt.step(d_grads)
        if epoch >= tr.train_G_after:
            state.g_opt.step(g_grads)
        if state.ema_g is not None:
            with torch.no_grad():
                ema = list(state.ema_g.values())
                torch._foreach_mul_(ema, tr.g_ema)
                torch._foreach_add_(ema, [g_named[k] for k in state.ema_g],
                                    alpha=1.0 - tr.g_ema)
        state.step += 1

        metrics["target_label"] = t
        if debug_grads:
            metrics["_grads"] = {"G": tp.gather_named(gen, g_grads),
                                 "D": tp.gather_named(disc, d_grads)}
            metrics["_drop"] = drop
        return state, metrics

    return step


def make_scan_train_steps(cfg: Config):
    """K train steps in a plain Python loop: fn(state, batches (K, V, B, H, W,
    3), draws (K of them), epoch) -> (state, metrics stacked to (K,))."""
    step_fn = make_train_step(cfg)

    def scan_fn(state: TrainState, batches: torch.Tensor, draws: Sequence[Draws],
                epoch: int) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if len(draws) != batches.shape[0]:
            raise ValueError(f"{batches.shape[0]} batches but {len(draws)} draws")
        per_step = []
        for batch, d in zip(batches, draws):
            state, m = step_fn(state, batch, d, epoch)
            per_step.append(m)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return scan_fn
