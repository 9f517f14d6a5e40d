"""The port's LM serving loop (``repro_torch.launch.serve``) and serve
steps (``repro_torch.train.make_serve_steps``) against the reference's, on
the CPU.

* The wave loop's generated tokens equal a greedy loop over the
  reference's own steps (``repro.train.make_serve_steps``'s decode, the
  prefill jitted with ``max_len`` as ``repro.launch.serve`` builds it), at
  f32, with the same weights and the same requests: waves in arrival
  order, the last one padded.
* ``main`` takes the reference's flags plus ``--device`` and serves on the
  CPU when asked (without a card it raises otherwise: see
  ``tests/test_torch_port_rules.py``).
* The serve steps keep one set of cache buffers per (batch, max_len) and
  reset them for every prefill.
* whisper's caches sized for the prompt alone, as the reference's own
  serving loop sizes them: the decode writes clamp onto the last slot in
  both packages, step for step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import build_model as ref_build
from repro.train.train_step import make_serve_steps as ref_serve_steps
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.train import make_serve_steps
from test_torch_lm_models import close, cfgs, port_params

BATCH, PROMPT, GEN, N_REQ = 2, 8, 6, 5


def _requests(cfg):
    rng = np.random.default_rng(11)
    return [rng.integers(0, cfg.vocab, PROMPT) for _ in range(N_REQ)]


def _ref_greedy(rcfg, params, requests, frames):
    """The reference's serving loop over its own steps, greedy."""
    model = ref_build(rcfg)
    _, decode_fn = ref_serve_steps(model)
    max_len = PROMPT + GEN
    enc_dec = rcfg.family == "encdec"
    if enc_dec:
        prefill = jax.jit(lambda p, t, f: model.prefill(p, t, f, max_len))
    else:
        prefill = jax.jit(lambda p, t: model.prefill(p, t, max_len))
    queue, done = list(requests), []
    while queue:
        wave, queue = queue[:BATCH], queue[BATCH:]
        n_real = len(wave)
        wave = wave + [np.zeros(PROMPT, np.int64)] * (BATCH - n_real)
        tokens = jnp.asarray(np.stack(wave), jnp.int32)
        if enc_dec:
            logits, caches, enc = prefill(params, tokens, frames)
        else:
            logits, caches = prefill(params, tokens)
        out = [jnp.argmax(logits[:, -1], axis=-1)]
        for i in range(GEN - 1):
            tok = out[-1][:, None].astype(jnp.int32)
            rest = (enc,) if enc_dec else ()
            logits, caches = decode_fn(params, caches, tok,
                                       jnp.int32(PROMPT + i), *rest)
            out.append(jnp.argmax(logits[:, 0], axis=-1))
        gen = np.stack([np.asarray(o) for o in out], axis=1)
        done.extend(gen[:n_real].tolist())
    return done


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-2b",
                                  "granite-moe-1b-a400m", "recurrentgemma-9b",
                                  "rwkv6-7b", "whisper-large-v3"])
def test_wave_loop_tokens_equal_the_reference_greedy_loop(arch):
    rcfg, pcfg = cfgs(arch, "float32")
    params, _ = ref_build(rcfg).init(jax.random.PRNGKey(5))
    pp = port_params(pcfg, params)
    requests = _requests(rcfg)
    frames = None
    if rcfg.family == "encdec":
        frames = np.random.default_rng(12).normal(
            size=(BATCH, rcfg.enc_seq, rcfg.d_model)).astype(np.float32)
    want = _ref_greedy(rcfg, params, requests,
                       None if frames is None else jnp.asarray(frames))
    got = serve.serve_waves(build_model(pcfg, device="cpu"), pp, requests,
                            BATCH, PROMPT, GEN,
                            None if frames is None
                            else torch.from_numpy(frames))
    assert got == want
    assert len(got) == N_REQ and all(len(g) == GEN for g in got)


def test_main_serves_on_the_cpu_when_asked(capsys):
    done = serve.main(["--arch", "qwen3-1.7b", "--smoke", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4", "--requests", "3",
                       "--device", "cpu"])
    assert len(done) == 3 and all(len(d) == 4 for d in done)
    assert "[serve] 3 sequences, 12 tokens" in capsys.readouterr().out


def test_main_serves_encdec_on_the_cpu(capsys):
    done = serve.main(["--arch", "whisper-large-v3", "--smoke", "--batch",
                       "2", "--prompt-len", "4", "--gen", "3", "--requests",
                       "2", "--device", "cpu"])
    assert len(done) == 2 and all(len(d) == 3 for d in done)


def test_serve_steps_reuse_and_reset_their_caches():
    """One set of cache buffers per (batch, max_len), reset by every
    prefill: a second prefill gives what a fresh ``model.prefill`` gives,
    in the first prefill's buffers."""
    _, pcfg = cfgs("gemma2-2b", "float32")
    model = build_model(pcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    prefill_fn, decode_fn = make_serve_steps(model)
    rng = np.random.default_rng(4)
    t1, t2 = (torch.from_numpy(rng.integers(0, pcfg.vocab, (2, 8))
                               .astype(np.int32)) for _ in range(2))
    _, c1 = prefill_fn(params, t1, max_len=12)
    for t in range(8, 11):
        decode_fn(params, c1, t1[:, :1], t)
    l2, c2 = prefill_fn(params, t2, max_len=12)
    assert all(a is b for a, b in zip(c2, c1))
    assert list(prefill_fn.caches) == [(2, 12)]
    want_l, want_c = model.prefill(params, t2, max_len=12)
    np.testing.assert_array_equal(l2.numpy(), want_l.numpy())
    for a, b in zip(c2, want_c):
        np.testing.assert_array_equal(a.k.numpy(), b.k.numpy())
        assert int(a.pos) == int(b.pos) == 8
    _, c3 = prefill_fn(params, t2[:1], max_len=12)
    assert c3[0] is not c1[0] and len(prefill_fn.caches) == 2


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-large-v3"])
def test_decoding_from_caches_a_later_prefill_reset_raises(arch):
    """A prefill resets its (batch, max_len)'s buffers: caches handed out
    by an earlier prefill of that shape are refused, not decoded from
    silently; the newest caches decode, and a prefill of another shape
    leaves them valid."""
    _, pcfg = cfgs(arch, "float32")
    model = build_model(pcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    prefill_fn, decode_fn = make_serve_steps(model)
    rng = np.random.default_rng(4)
    t1, t2 = (torch.from_numpy(rng.integers(0, pcfg.vocab, (2, 8))
                               .astype(np.int32)) for _ in range(2))
    frames = ((torch.zeros((2, pcfg.enc_seq, pcfg.d_model)),)
              if pcfg.family == "encdec" else ())
    out1 = prefill_fn(params, t1, *frames, max_len=12)
    out2 = prefill_fn(params, t2, *frames, max_len=12)
    rest = tuple(out2[2:])
    with pytest.raises(RuntimeError, match="stale caches"):
        decode_fn(params, out1[1], t1[:, :1], 8, *rest)
    prefill_fn(params, t2[:1], *(f[:1] for f in frames), max_len=12)
    logits, caches = decode_fn(params, out2[1], t2[:, :1], 8, *rest)
    assert caches is out2[1] and logits.shape[:2] == (2, 1)


def test_serving_is_the_same_whether_the_parameters_take_gradients():
    """Training turns gradients on for the parameters; the serve steps run
    without them, so their logits are the same bits and carry no graph."""
    _, pcfg = cfgs("qwen3-1.7b", "float32")
    model = build_model(pcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, pcfg.vocab, (2, 8)).astype(np.int32))
    outs = []
    for grad in (False, True):
        params.requires_grad_(grad)
        prefill_fn, decode_fn = make_serve_steps(model)
        lp, caches = prefill_fn(params, tokens, max_len=10)
        ld, _ = decode_fn(params, caches, tokens[:, :1], 8)
        assert not lp.requires_grad and not ld.requires_grad
        outs.append((lp, ld))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_whisper_caches_sized_for_the_prompt_clamp_as_the_reference():
    """The reference's serving loop sizes whisper's caches for the prompt
    alone; each decode write then lands, clamped, on the last slot.  The
    port reproduces the clamp step for step (its own loop sizes the caches
    for prompt + gen)."""
    rcfg, pcfg = cfgs("whisper-large-v3", "float32")
    rm = ref_build(rcfg)
    params, _ = rm.init(jax.random.PRNGKey(6))
    pp = port_params(pcfg, params)
    pm = build_model(pcfg, device="cpu")
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, rcfg.vocab, (2, 6)).astype(np.int32)
    frames = rng.normal(size=(2, rcfg.enc_seq, rcfg.d_model)).astype(
        np.float32)
    lr, rc, renc = rm.prefill(params, jnp.asarray(tokens), jnp.asarray(frames))
    lp, pc, penc = pm.prefill(pp, torch.from_numpy(tokens),
                              torch.from_numpy(frames))
    close(lp, lr, "float32")
    tok = tokens[:, -1:]
    for t in range(6, 9):
        lr, rc = rm.decode_step(params, rc, jnp.asarray(tok), jnp.int32(t),
                                renc)
        lp, pc = pm.decode_step(pp, pc, torch.from_numpy(tok), t, penc)
        close(lp, lr, "float32", f"step {t}")
        tok = np.asarray(jnp.argmax(lr[:, 0], -1))[:, None].astype(np.int32)
    assert all(int(c.pos) == 9 for c in pc)


def test_build_model_keeps_the_config():
    _, pcfg = cfgs("qwen3-1.7b")
    pcfg = dataclasses.replace(pcfg, n_layers=2)
    model = build_model(pcfg, device="cpu")
    params = model.init()
    assert model.cfg is pcfg and model.device == torch.device("cpu")
    assert len(params["blocks"]) == 2
    assert model.param_count(params) == sum(
        p.numel() for p in params.parameters())
