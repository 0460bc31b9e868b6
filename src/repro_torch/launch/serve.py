"""Serving entry point of the PyTorch port: ``--mode lm``, LM generation.

``--mode lm`` (the default) prefills a batch of prompts through a reduced
or full assigned architecture (``--arch``, default falcon-mamba-7b), then
decodes ``--gen`` tokens with the KV-cache / SSM-state serving path of
:mod:`repro_torch.models.transformer`.  The weights are a random init from
``--seed``, the prompts ``synthetic.lm_tokens``, and a VLM's or the
encoder-decoder's modal input a seeded stub of frame or patch embeddings.
``--flash`` routes the cache-free attention (the encoder-decoder's encoder,
non-causal) through the hand-written flash kernel.  It prints the
reference's JSON keys (``arch``, ``generated_shape``, ``first_seq``,
``prefill_s``, ``decode_s_per_tok``) plus ``device``; the times end in a
device synchronise.

``--mode fl``, serving a federation's coalition models from a model store,
waits for the port of ``serve/`` and ``checkpoint/`` (ROADMAP queue A.5)
and exits non-zero.

The run is on a CUDA card unless the caller passes ``--device cpu``;
without a card and without ``--device cpu`` it exits non-zero.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --full
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch seamless-m4t-large-v2 --full --flash
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.launch.train import resolve_device

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, batch: dict, *, max_new: int, cache_len: int,
             greedy: bool = True, generator: torch.Generator | None = None,
             gumbel: torch.Tensor | None = None):
    """Prefill, then ``max_new`` decode steps.  Returns (tokens (B,
    max_new), stats): the first token is the prefill's argmax, each later
    one the argmax of a decode step's logits, or with ``greedy=False`` a
    sample, argmax(logits + Gumbel noise) as ``jax.random.categorical``
    draws it: the noise ``gumbel[i]`` (max_new, B, vocab) where given,
    else drawn from ``generator``.  ``stats``: ``prefill_s``,
    ``decode_s_per_tok`` (host seconds, each ended by a device
    synchronise) and ``logits_finite``."""
    from repro_torch.models import transformer as tf

    tokens = batch["tokens"]
    device = tokens.device
    b = tokens.shape[0]
    with torch.no_grad():
        cache = tf.init_cache(model.cfg, b, cache_len, device=device)
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = tf.prefill(model, batch, cache)
        _sync(device)
        prefill_s = time.perf_counter() - t0

        finite = torch.isfinite(logits).all()
        toks = []
        tok = torch.argmax(logits, dim=-1)
        t0 = time.perf_counter()
        for i in range(max_new):
            toks.append(tok)
            logits, cache = tf.decode_step(model, tok, cache)
            finite &= torch.isfinite(logits).all()
            if greedy:
                tok = torch.argmax(logits, dim=-1)
            else:
                noise = gumbel[i] if gumbel is not None else -torch.log(
                    torch.empty_like(logits).exponential_(
                        generator=generator))
                tok = torch.argmax(logits + noise.to(logits), dim=-1)
        _sync(device)
        decode_s = time.perf_counter() - t0
    return torch.stack(toks, dim=1), {
        "prefill_s": prefill_s, "decode_s_per_tok": decode_s / max_new,
        "logits_finite": bool(finite)}


def run_lm(args, *, model=None, modal: torch.Tensor | None = None) -> dict:
    """Serve one batch: init, prefill and decode; print the reference's
    keys plus ``device``.  The random draws may be given instead: ``model``
    (its parameters; e.g. the reference's, by ``carry``) and ``modal``, the
    stub's (B, P, d_modal) input.  Returns the printed keys and, beside
    them, the generated ``tokens``, the ``model``, its ``batch`` and
    ``logits_finite``."""
    from repro_torch.configs import get, reduced
    from repro_torch.data import synthetic
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf

    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    layers.set_flash_kernel(args.flash)
    cfg = get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    gen = torch.Generator(device=device)
    if model is None:
        model = tf.init(gen.manual_seed(args.seed), cfg, device=device)
    toks = synthetic.lm_tokens(args.batch, args.prompt_len, cfg.vocab,
                               seed=args.seed)
    batch = {"tokens": torch.from_numpy(toks).to(device)}
    if cfg.modality:
        batch["modal"] = (modal.to(device) if modal is not None else
                          torch.randn((args.batch, cfg.n_modal_tokens,
                                       cfg.d_modal),
                                      generator=gen.manual_seed(1),
                                      device=device))
    prefix = cfg.n_modal_tokens if (cfg.modality and not cfg.enc_dec) else 0
    out, stats = generate(model, batch, max_new=args.gen,
                          cache_len=prefix + args.prompt_len + args.gen,
                          generator=gen.manual_seed(args.seed + 2))
    layers.set_flash_kernel(False)
    result = {"arch": cfg.name, "generated_shape": list(out.shape),
              "first_seq": [int(t) for t in out[0][:8]],
              "prefill_s": stats["prefill_s"],
              "decode_s_per_tok": stats["decode_s_per_tok"],
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")}
    print(json.dumps(result))
    if not stats["logits_finite"]:
        raise RuntimeError(f"{cfg.name}: non-finite logits while serving")
    return {**result, "tokens": out, "model": model, "batch": batch,
            "logits_finite": stats["logits_finite"]}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", default="lm", choices=["lm", "fl"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; exits "
                         "non-zero without a card unless this is cpu)")
    ap.add_argument("--arch", default="falcon-mamba-7b")
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--reduced", dest="reduced", action="store_true",
                      help="serve the reduced (CPU-smoke) config [default]")
    size.add_argument("--full", dest="reduced", action="store_false",
                      help="serve the full-size config")
    ap.set_defaults(reduced=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--flash", action="store_true",
                    help="route the cache-free attention through the "
                         "hand-written flash kernel")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.mode == "fl":
        raise SystemExit("serve --mode fl (coalition-routed serving from a "
                         "model store) is not ported yet: it waits for "
                         "serve/ and checkpoint/ (ROADMAP queue A.5)")
    return run_lm(args)


if __name__ == "__main__":
    main()
