"""The reference's train steps: T1 (supervised source training) and T2
(PnP-AdaNet adaptation), plain PyTorch, one eager step at a time.

A step takes flat {path: tensor} leaves and returns new ones, with the
metrics a run logs and the gradients as the optimiser got them.  The
math after the batch draw (``source_grads``, ``adapt_grads``) also runs
on meta tensors, where the FLOP count reads it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import pnp_adanet as ref


def _augment(gen, x, n_image: int, data: dict):
    draws = ref.draw_params(gen, x.shape[0], x.device,
                            data["rotate_degrees"], data["zoom_range"],
                            data["shift_pixels"])
    return ref.warp(x, draws, n_image)


def source_batch(gen, images, labels, data: dict):
    """A T1 batch: indices drawn uniformly with replacement, the one-hot
    labels packed behind the image channels, one joint warp.  ``data``'s
    ``keep``, where given, keeps that many of the batch (a fault)."""
    idx = torch.randint(0, images.shape[0], (data["batch_size"],),
                        generator=gen, device=images.device)
    image = images[idx]
    onehot = F.one_hot(labels[idx].long(), data["num_classes"]).float()
    c = image.shape[-1]
    both = _augment(gen, torch.cat([image, onehot], -1), c, data)
    keep = data.get("keep", both.shape[0])
    return both[:keep, ..., :c], both[:keep, ..., c:]


def source_grads(params, bn, image, onehot, rnd=None):
    """-> (loss, xent, dice_loss, grads {path: tensor}, new BN state)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    logits, probs, _, new_bn = ref.forward(ref.nest(leaves), bn, image,
                                           train=True, rnd=rnd)
    loss, xe, dl = ref.segmentation_loss(logits, probs, onehot)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), xe.detach(), dl.detach(), \
        dict(zip(leaves, grads)), new_bn


def source_step(params, bn, opt, adam: ref.Adam, data_arrays, gen,
                data: dict, rnd=None):
    """One T1 step -> (params, bn, opt, metrics, grads)."""
    image, onehot = source_batch(gen, data_arrays["images"],
                                 data_arrays["labels"], data)
    loss, xe, dl, grads, new_bn = source_grads(params, bn, image, onehot, rnd)
    params, opt = adam.step(params, grads, opt)
    return params, new_bn, opt, {"loss": loss, "xent": xe,
                                 "dice_loss": dl}, grads


def adapt_batches(gen, src_images, tgt_images, data: dict):
    b = data["batch_size"]
    i_s = torch.randint(0, src_images.shape[0], (b,), generator=gen,
                        device=src_images.device)
    x_s = src_images[i_s]
    i_t = torch.randint(0, tgt_images.shape[0], (b,), generator=gen,
                        device=tgt_images.device)
    x_t = tgt_images[i_t]
    both = _augment(gen, torch.cat([x_s, x_t]), x_s.shape[-1], data)
    keep = data.get("keep", b)
    return both[:b][:keep], both[b:][:keep]


def adapt_grads(st: dict, x_s, x_t, adapt: dict, rnd=None):
    """The adapt step's math up to its updates: the shared target forward
    (gradients to the DAM), the bf16 frozen source forward, the critic's
    least-squares loss and gradient, its accuracy, and the DAM's loss
    under the critic after its update.  ``st``: src_params, src_bn, dam,
    tgt_bn, critic (flat leaves where trained), opt_d, adam_d.  -> (d
    grads, critic after its step, opt_d, g grads, new target BN,
    metrics)."""
    plug = adapt["plug_depth"]
    dam_leaves = {k: v.detach().requires_grad_() for k, v in st["dam"].items()}
    with torch.enable_grad():
        _, _, taps_g, new_tgt_bn = ref.forward(
            st["src_params"], st["tgt_bn"], x_t, train=True,
            dam=ref.nest(dam_leaves), plug_depth=plug, rnd=rnd)
    f_tgt = {k: v.detach().float() for k, v in taps_g.items()}
    with torch.no_grad():
        _, _, taps_s, _ = ref.forward(st["src_params"], st["src_bn"], x_s,
                                      train=True, dtype=torch.bfloat16,
                                      rnd=rnd)
    f_src = {k: v.float() for k, v in taps_s.items()}
    c_leaves = {k: v.detach().requires_grad_()
                for k, v in st["critic"].items()}
    with torch.enable_grad():
        cp = ref.nest(c_leaves)
        l_s = ref.critic_logits(cp, f_src, rnd)
        l_t = ref.critic_logits(cp, f_tgt, rnd)
        d_loss = 0.5 * (torch.mean((l_s.float() - 1.0) ** 2)
                        + torch.mean(l_t.float() ** 2))
        d_grads = dict(zip(c_leaves, torch.autograd.grad(
            d_loss, list(c_leaves.values()))))
    l_s, l_t = l_s.detach(), l_t.detach()
    acc = 0.5 * (torch.mean((l_s > 0.5).float())
                 + torch.mean((l_t <= 0.5).float()))
    gate = acc <= adapt["d_acc_cap"] if adapt["d_acc_cap"] < 1.0 else None
    critic, opt_d = st["adam_d"].step(st["critic"], d_grads, st["opt_d"],
                                      gate)
    with torch.enable_grad():
        lg = ref.critic_logits(ref.nest(critic), taps_g, rnd)
        g_loss = 0.5 * torch.mean((lg.float() - 1.0) ** 2)
        g_grads = dict(zip(dam_leaves, torch.autograd.grad(
            g_loss, list(dam_leaves.values()))))
    return d_grads, critic, opt_d, g_grads, new_tgt_bn, {
        "d_loss": d_loss.detach(), "d_acc": acc, "g_loss": g_loss.detach()}


def adapt_step(st: dict, data_arrays, gen, data: dict, adapt: dict,
               rnd=None):
    """One T2 step on ``st`` (see ``adapt_grads``; plus adam_g, opt_g) ->
    (new st, metrics, (d grads, g grads))."""
    x_s, x_t = adapt_batches(gen, data_arrays["src"], data_arrays["tgt"],
                             data)
    d_grads, critic, opt_d, g_grads, new_bn, metrics = adapt_grads(
        st, x_s, x_t, adapt, rnd)
    dam, opt_g = st["adam_g"].step(st["dam"], g_grads, st["opt_g"])
    new = dict(st, critic=critic, opt_d=opt_d, dam=dam, opt_g=opt_g,
               tgt_bn=new_bn)
    return new, metrics, (d_grads, g_grads)
