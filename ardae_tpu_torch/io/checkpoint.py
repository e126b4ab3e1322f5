"""Checkpoint save and restore (JAX twin: ardae_tpu/io/checkpoint.py;
reference utils/msc.py:67-110).

One ``torch.save`` file per name (``checkpoint``, ``best-checkpoint``,
``final-checkpoint``) holds a dict of tensors and Python scalars only, so
``torch.load(weights_only=True)`` reads it on the card or on the CPU:
``TrainState.state_dict()`` (the model and its optimizer, the cdae and its
optimizer where the state has them, the averaged model and its count under
weight averaging, the step), the training generator's
state, and the meta (``i_ep``, ``epoch``,
``batch_idx``, ``train_num_iters_per_epoch``, ``best_val_loss`` with -inf
for none). The generator state makes a resumed run continue the same noise
stream. The host-side data-shuffle position restarts on resume, as the
reference's DataLoader iterator does.

A save writes ``<name>.tmp-save``, moves the live file to ``<name>.tmp-old``,
moves the new file in and deletes the old one; a load recovers from those
temporaries when a crash fell between the steps.
"""

import os
import pickle

import torch

from ardae_tpu_torch.io.logging import logging
from ardae_tpu_torch.train.state import avg_copy

# what torch.load raises on a partial or foreign file
_UNREADABLE = (RuntimeError, EOFError, OSError, pickle.UnpicklingError)


def _target(path, filename):
    return os.path.abspath(os.path.join(path, filename))


def save_checkpoint(state, meta, path, filename="checkpoint", generator=None):
    """Save ``state`` (a TrainState), ``meta`` and the generator's state;
    replaces the checkpoint of that name. Returns the file's path."""
    target = _target(path, filename)
    payload = {"state": state.state_dict(),
               "generator": None if generator is None else generator.get_state(),
               "meta": {k: (v if isinstance(v, (int, float)) else float(v))
                        for k, v in meta.items()}}
    # write-new-then-swap: removing the live file before the new one is
    # complete would lose the only copy if the process dies in between
    tmp, old = target + ".tmp-save", target + ".tmp-old"
    torch.save(payload, tmp)
    if os.path.exists(old):
        os.remove(old)
    if os.path.exists(target):
        os.rename(target, old)
    os.rename(tmp, target)
    if os.path.exists(old):
        os.remove(old)
    return target


def _read(path, map_location):
    return torch.load(path, map_location=map_location, weights_only=True)


def _meta_recency(payload):
    """Completed iterations recorded in a payload's meta, to tell which of
    two readable checkpoints is newer; -1 if the meta is malformed."""
    try:
        meta = payload["meta"]
        if "i_ep" in meta:
            return int(meta["i_ep"])
        return ((int(meta["epoch"]) - 1) * int(meta["train_num_iters_per_epoch"])
                + int(meta["batch_idx"]))
    except (KeyError, TypeError, ValueError):
        return -1


def _read_with_recovery(target, map_location):
    """(payload, source) of ``target``, or of a temporary a crashed save
    left; None if there is none.

    - The live file and a readable ``.tmp-save`` (a crash after the new
      file was complete, before the swap): the newer by meta wins, but a
      live file whose meta is malformed keeps priority, since nothing says
      the ``.tmp-save`` is newer.
    - No live file: ``.tmp-save`` (the newer) before ``.tmp-old``; an
      unreadable temporary (a partial write) is skipped. An unreadable
      live file raises."""
    tmp_save = target + ".tmp-save"
    if os.path.exists(target) and os.path.exists(tmp_save):
        live = _read(target, map_location)
        try:
            pending = _read(tmp_save, map_location)
        except _UNREADABLE as e:
            logging(f"=> recovery candidate '{tmp_save}' unreadable ({e}); skipping")
            return live, target
        live_at = _meta_recency(live)
        if live_at >= 0 and _meta_recency(pending) > live_at:
            logging(f"=> recovered newer complete save '{tmp_save}' over the "
                    "live checkpoint (crash between save and swap)")
            return pending, tmp_save
        return live, target
    for cand, is_recovery in ((target, False), (tmp_save, True),
                              (target + ".tmp-old", True)):
        if not os.path.exists(cand):
            continue
        try:
            payload = _read(cand, map_location)
        except _UNREADABLE as e:
            if not is_recovery:
                raise
            logging(f"=> recovery candidate '{cand}' unreadable ({e}); skipping")
            continue
        if is_recovery:
            logging(f"=> recovered checkpoint from an interrupted save: '{cand}'")
        return payload, cand
    return None


def load_checkpoint(state, path, filename="checkpoint", generator=None):
    """Restore into ``state`` (and ``generator``) in place, every tensor
    onto the device of ``state``'s model. Returns (state, meta), or None
    when there is no checkpoint (the reference prints and goes on,
    utils/msc.py:95-96).

    Where ``state`` and the file disagree on the weight-averaging slots, the
    state follows the file, as the JAX twin's skeleton does: a state built
    without them takes them from a run saved with averaging (widened), and
    one built with them drops them for a run saved without (narrowed; it
    then evaluates the live model). Any other mismatch raises."""
    target = _target(path, filename)
    device = next(state.model.parameters()).device
    rec = _read_with_recovery(target, device)
    if rec is None:
        logging(f"=> no checkpoint found at '{target}'")
        return None
    payload, source = rec
    saved_avg = "avg_model" in payload["state"]
    if saved_avg and state.avg_model is None:
        state.avg_model, state.avg_count = avg_copy(state.model), 0
        logging("=> checkpoint carries averaged params; widened the skeleton")
    elif not saved_avg and state.avg_model is not None:
        state.avg_model, state.avg_count = None, None
        logging("=> checkpoint has no averaged params; narrowed the skeleton"
                " (evaluate with the live params)")
    state.load_state_dict(payload["state"])
    if generator is not None and payload["generator"] is not None:
        generator.set_state(payload["generator"].cpu())
    logging(f"=> loaded checkpoint '{source}'")
    return state, dict(payload["meta"])


def load_end_iter(path, filename="best-checkpoint"):
    """Final-mode end iteration from a checkpoint's meta (reference
    utils/msc.py:98-110): (epoch - 1) * iters + batch_idx - 1.

    Reference quirk, kept: the meta records N completed iterations, and
    the -1 with the driver's stop at end_iter makes a final-mode run N - 1
    iterations long, like the reference's ``(i_ep+1) > opt.end_iter``
    break (ivae_ardae.py:698-700)."""
    target = _target(path, filename)
    rec = _read_with_recovery(target, "cpu")
    if rec is None:
        raise ValueError(f"=> no checkpoint found at '{target}'")
    meta = rec[0]["meta"]
    return ((int(meta["epoch"]) - 1) * int(meta["train_num_iters_per_epoch"])
            + int(meta["batch_idx"]) - 1)
