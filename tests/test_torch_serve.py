"""The port's serving entry point (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``), on the CPU.

- ``generate`` on the reference's weights and the same prompts (and modal
  input): the greedy tokens equal the reference's, for the SSM, hybrid,
  VLM, MoE and encoder-decoder families at their reduced (f32) configs;
  and sampling, given the reference's Gumbel noise (``jax.random
  .categorical`` is the argmax of logits + Gumbel noise), equal tokens.
- ``--mode lm --device cpu --reduced`` prints one JSON line with the
  reference CLI's keys plus ``device``, and with the reference's draws
  given (its init, its modal stub) the reference's tokens; ``--mode fl``
  without ``--store-dir`` exits non-zero (tests/test_torch_serve_fl.py
  covers the mode), and so does a run without ``--device cpu`` on a host
  without a card.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.models import transformer as jtf
from repro_torch import carry
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.testing import cap_cpu_threads

cap_cpu_threads()

B, PROMPT, GEN = 2, 8, 5


def _served(arch):
    jcfg, tcfg = jreg.reduced(jreg.get(arch)), treg.reduced(treg.get(arch))
    params = jax.tree.map(np.asarray, jtf.init(jax.random.key(0), jcfg))
    model = carry.transformer_from_jax(params, tcfg)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab, (B, PROMPT)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens)}
    if jcfg.modality:
        modal = rng.standard_normal(
            (B, jcfg.n_modal_tokens, jcfg.d_modal)).astype(np.float32)
        jb["modal"], tb["modal"] = jnp.asarray(modal), torch.from_numpy(modal)
    prefix = jcfg.n_modal_tokens if (jcfg.modality
                                     and not jcfg.enc_dec) else 0
    return jcfg, params, model, jb, tb, prefix + PROMPT + GEN


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b",
                                  "phi-3-vision-4.2b", "moonshot-v1-16b-a3b",
                                  "seamless-m4t-large-v2"])
def test_greedy_generate_matches_reference(arch):
    jcfg, params, model, jb, tb, cache_len = _served(arch)
    want, _ = jserve.generate(params, jcfg, jb, max_new=GEN,
                              cache_len=cache_len)
    got, stats = serve.generate(model, tb, max_new=GEN, cache_len=cache_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["logits_finite"]
    assert stats["prefill_s"] > 0 and stats["decode_s_per_tok"] > 0


def test_sampled_generate_matches_reference():
    jcfg, params, model, jb, tb, cache_len = _served("starcoder2-7b")
    key = jax.random.key(9)
    want, _ = jserve.generate(params, jcfg, jb, max_new=GEN,
                              cache_len=cache_len, greedy=False, key=key)
    noise = []
    for _ in range(GEN):               # the reference's draws, in its order
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.gumbel(sub, (B, jcfg.vocab))))
    got, _ = serve.generate(model, tb, max_new=GEN, cache_len=cache_len,
                            greedy=False, gumbel=torch.from_numpy(
                                np.stack(noise)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    greedy, _ = serve.generate(model, tb, max_new=GEN, cache_len=cache_len)
    assert not torch.equal(got, greedy)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "phi-3-vision-4.2b"])
def test_cli_prints_the_reference_keys_plus_device(arch, capsys):
    """The CLI's line has the reference's keys plus ``device``; given the
    reference's draws (its init at the seed, its modal stub), run_lm serves
    the reference's tokens."""
    args = serve.build_parser().parse_args(
        ["--mode", "lm", "--device", "cpu", "--reduced", "--prompt-len",
         str(PROMPT), "--gen", str(GEN), "--arch", arch])
    jcfg = jreg.reduced(jreg.get(arch))
    params = jax.tree.map(np.asarray, jtf.init(jax.random.key(args.seed),
                                               jcfg))
    modal = None
    if jcfg.modality:
        modal = torch.from_numpy(np.array(jax.random.normal(
            jax.random.key(1),
            (args.batch, jcfg.n_modal_tokens, jcfg.d_modal))))
    out = serve.run_lm(args, model=carry.transformer_from_jax(
        params, treg.reduced(treg.get(arch))), modal=modal)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jserve.run_lm(argparse.Namespace(
        arch=arch, reduced=True, batch=args.batch, prompt_len=PROMPT,
        gen=GEN, seed=args.seed))
    capsys.readouterr()
    assert set(line) == set(want) | {"device"}
    assert line["device"] == "cpu"
    for key in ("arch", "generated_shape", "first_seq"):
        assert line[key] == want[key], key
    assert out["logits_finite"] and line["generated_shape"] == [4, GEN]
    serve.main(["--device", "cpu", "--reduced", "--gen", "2"])   # own draws
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == set(want) | {"device"}


def test_cli_fl_mode_exits_nonzero():
    with pytest.raises(SystemExit, match="--store-dir") as exc:
        serve.main(["--mode", "fl", "--device", "cpu"])
    assert exc.value.code not in (0, None)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cli_without_card_exits_nonzero():
    with pytest.raises(SystemExit, match="--device cpu") as exc:
        serve.main(["--reduced"])
    assert exc.value.code not in (0, None)
