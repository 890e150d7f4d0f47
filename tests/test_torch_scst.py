"""Port parity of sampling and self-critical sequence training against the
JAX package, on the CPU, in f32:

- generate_no_beam's sampling with pinned noise: the port draws Gumbel noise
  from a torch.Generator; the same noise, replayed from a generator seeded
  alike, goes into JAX's loop through a stand-in for jax.random.categorical
  (JAX runs eagerly here, jax.disable_jit, so the stand-in sees every step).
  Cases: top_p < 1, temperature, min_length, rows that finish at step one;
  tokens equal, summed log-probs within 1e-5. The same for
  XVLMForCaptioning.generate(do_sample=True) at K samples an image;
- 10^4 draws from fixed logits against the top_p-filtered softmax (JAX's
  top_p_filter): every frequency within 4.5 binomial standard deviations
  plus 1e-3, filtered tokens never drawn;
- sequence_logprobs (a row with no EOS among them) within 1e-5, both reward
  baselines within 1e-5;
- one SCST grad step against JAX's make_scst_step: the loss rtol 2e-4, the
  clipped gradients (each side's Adam first moment / (1 - b1)) rtol 5e-3
  with a floor of 5e-4 of the leaf's largest, the updated params as
  tests/test_torch_task_train.py holds a step's;
- the --scst CLI on the CPU: an epoch of 2 steps, and one preempted after
  its first step and resumed: the replayed epoch's host draws (ground truths
  picked, transform) and per-step generators equal the uninterrupted
  epoch's, bit for bit, and its losses equal a run from the saved state by
  hand."""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import io_callback
from PIL import Image

from efficientvlm_tpu import config as jcfg
from efficientvlm_tpu import generation as JG
from efficientvlm_tpu.evaluation.caption_metrics import CiderD as JCiderD
from efficientvlm_tpu.models import model_generation as JM
from efficientvlm_tpu.train import optim as JO
from efficientvlm_tpu.train.scheduler import create_scheduler as j_scheduler
from efficientvlm_tpu.train import scst as JS
from efficientvlm_tpu_torch import config as tcfg
from efficientvlm_tpu_torch import generation as TG
from efficientvlm_tpu_torch.bridge import params_from_numpy
from efficientvlm_tpu_torch.data.tokenizer import build_tokenizer
from efficientvlm_tpu_torch.drivers import captioning as TCap
from efficientvlm_tpu_torch.drivers import common as TDC
from efficientvlm_tpu_torch.models import model_generation as TM
from efficientvlm_tpu_torch.run import main as cli_main
from efficientvlm_tpu_torch.train import checkpoint as TC
from efficientvlm_tpu_torch.train import optim as TO
from efficientvlm_tpu_torch.train import scst as TS
from efficientvlm_tpu_torch.train.steps import init_pretrain_state

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, EOS, PAD = 12, 2, 0
VISION = dict(vision_width=32, num_attention_heads=4, intermediate_size=64,
              num_hidden_layers=2, image_res=16, patch_size=8)
TEXT = dict(vocab_size=30, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, encoder_width=32, max_position_embeddings=16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
LR, B1, EPS = 1e-3, 0.9, 1e-8


def _noise_replay(seed, shape, steps):
    g = torch.Generator().manual_seed(seed)
    return [TG.gumbel_noise(shape, g, "cpu").numpy() for _ in range(steps)]


def _pinned_categorical(monkeypatch, noises):
    """jax.random.categorical's Gumbel-max with the next pinned noise: an
    ordered io_callback hands the loop body one draw an iteration."""
    it = iter(noises)

    def categorical(key, logits, axis=-1):
        noise = io_callback(lambda: next(it), jax.ShapeDtypeStruct(logits.shape, jnp.float32),
                            ordered=True)
        return jnp.argmax(logits + noise, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)


def _table(seed):
    """Logits by last token and position: row EOS of token 7 dominates, so a
    prompt ending in 7 finishes at step one unless min_length holds it."""
    rng = np.random.default_rng(seed)
    tok = rng.standard_normal((V, V)).astype(np.float32) * 2.0
    tok[7, EOS] = 12.0
    return tok, rng.standard_normal((16, V)).astype(np.float32)


def _decoders(seed):
    tok, pos = _table(seed)

    def jax_fn(tokens, cache, offset):
        p = jnp.asarray(pos)[offset + jnp.arange(tokens.shape[1])]
        return jnp.asarray(tok)[tokens] + p[None], cache

    def torch_fn(tokens, cache, offset):
        p = torch.from_numpy(pos)[offset + torch.arange(tokens.shape[1])]
        return torch.from_numpy(tok)[tokens] + p[None], cache

    return jax_fn, torch_fn


SAMPLE_CASES = [dict(top_p=1.0, temperature=1.0, min_length=0),
                dict(top_p=0.7, temperature=1.0, min_length=0),
                dict(top_p=0.9, temperature=0.6, min_length=0),
                dict(top_p=0.8, temperature=1.3, min_length=5)]


@pytest.mark.parametrize("case", SAMPLE_CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_sampled_tokens_match_jax_with_pinned_noise(case, monkeypatch):
    """Six rows, two of them ending their prompt in the token whose EOS
    logit dominates: at min_length 0 they finish at step one (pads after,
    their sum frozen); at min_length 5 EOS is masked until then."""
    jfn, tfn = _decoders(3)
    prompt = np.array([[1, 7], [1, 4], [1, 7], [1, 9], [1, 5], [1, 3]])
    max_length, seed = 10, 11
    kw = dict(max_length=max_length, eos_id=EOS, pad_id=PAD, do_sample=True, **case)
    got, got_lp = TG.generate_no_beam(tfn, [], torch.from_numpy(prompt), **kw,
                                      generator=torch.Generator().manual_seed(seed))
    _pinned_categorical(monkeypatch, _noise_replay(seed, (6, V), max_length))
    want, want_lp = jax.jit(lambda q: JG.generate_no_beam(jfn, [], q, **kw))(prompt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-5, rtol=0)
    if case["min_length"] == 0:
        assert (got[[0, 2], 2] == EOS).all() and (got[[0, 2], 3:] == PAD).all()
    else:
        assert not (got[:, 2:case["min_length"]] == EOS).any()


def test_greedy_unchanged_by_a_generator():
    """do_sample=False ignores the generator: the argmax decode."""
    _, tfn = _decoders(4)
    prompt = torch.tensor([[1, 4], [1, 9]])
    a, _ = TG.generate_no_beam(tfn, [], prompt, max_length=8, eos_id=EOS, pad_id=PAD)
    b, _ = TG.generate_no_beam(tfn, [], prompt, max_length=8, eos_id=EOS, pad_id=PAD,
                               generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)


@pytest.mark.parametrize("top_p", [1.0, 0.8])
def test_draw_frequencies_follow_the_filtered_softmax(top_p):
    """10^4 draws of sample_tokens from fixed logits, one row repeated, against
    softmax(JAX's top_p_filter(logits))."""
    logits = np.array([2.0, 1.5, 1.0, 0.2, -0.5, -1.0, 0.7, -3.0], np.float32)
    n = 10_000
    draws = TG.sample_tokens(torch.from_numpy(np.tile(logits, (n, 1))), top_p=top_p,
                             generator=torch.Generator().manual_seed(5))
    freq = np.bincount(draws.numpy(), minlength=logits.size) / n
    p = np.asarray(jax.nn.softmax(JG.top_p_filter(jnp.asarray(logits), top_p)))
    sd = np.sqrt(p * (1 - p) / n)
    assert (np.abs(freq - p) <= 4.5 * sd + 1e-3).all(), (freq, p)
    assert (freq[p < 1e-12] == 0).all()


def test_sequence_logprobs_match_jax():
    """Rows: EOS mid-way then pads; EOS at the last position; no EOS at all
    (the whole generated span counts); EOS right after the prompt."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 7, 11)).astype(np.float32)
    tokens = np.array([[5, 6, 3, EOS, PAD, PAD, PAD],
                       [5, 6, 3, 4, 8, 9, EOS],
                       [5, 6, 3, 4, 8, 9, 10],
                       [5, 6, EOS, PAD, PAD, PAD, PAD]])
    kw = dict(prompt_length=2, eos_id=EOS, pad_id=PAD)
    got = TS.sequence_logprobs(torch.from_numpy(logits), torch.from_numpy(tokens), **kw)
    want = JS.sequence_logprobs(jnp.asarray(logits), jnp.asarray(tokens), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("baseline", ["greedy", "sample"])
def test_rewards_match_jax(baseline):
    """Both baselines over three images, three samples each (a trailing '.'
    and repeated captions among them); the mean sample score too."""
    gts = [["a dog runs in the park", "a brown dog running."],
           ["a cat sleeps on the mat", "the cat is asleep"],
           ["two people ride bikes", "people on bicycles in a street"]]
    sampled = ["a dog runs in the park.", "banana flux", "a dog running",
               "a cat sleeps", "a cat sleeps", "the mat",
               "two people", "people ride bikes on a street", "bikes."]
    greedy = ["a dog", "a cat on the mat", "banana"] if baseline == "greedy" else None
    t = TS.ScstRewardCriterion(sample_n=3, baseline_type=baseline)
    j = JS.ScstRewardCriterion(sample_n=3, baseline_type=baseline)
    np.testing.assert_allclose(t.rewards(gts, sampled, greedy), j.rewards(gts, sampled, greedy),
                               atol=1e-5, rtol=0)
    assert t.get_score() == pytest.approx(j.get_score(), abs=1e-6)
    assert type(t.scorer).__name__ == JCiderD.__name__


@pytest.fixture(scope="module")
def models():
    jv, jt = jcfg.VisionConfig.create(**VISION), jcfg.TextConfig.create(**TEXT)
    tv, tt = tcfg.VisionConfig.create(**VISION), tcfg.TextConfig.create(**TEXT)
    jm = JM.XVLMForCaptioning(jv, jt, jcfg.Config({"prompt_length": 2}))
    tm = TM.XVLMForCaptioning(tv, tt, tcfg.Config({"prompt_length": 2}))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    image = np.random.default_rng(1).standard_normal((2, 16, 16, 3)).astype(np.float32)
    return jm, tm, jp, image


def test_captioning_samples_match_jax(models, monkeypatch):
    """generate(do_sample=True, top_p=0.9) at K = 3 rows an image (the port
    decodes them over the image's shared cross K/V, JAX over the repeated
    image) against JAX with the same noise."""
    jm, tm, jp, image = models
    tp = params_from_numpy(jp, device="cpu")
    k, seed = 3, 21
    prompt = np.array([[1, 5], [1, 6]])
    kw = dict(max_length=6, min_length=3, eos_id=EOS, pad_id=PAD, num_beams=1)
    got = tm.generate(tp, torch.from_numpy(image), torch.from_numpy(prompt), do_sample=True,
                      top_p=0.9, num_return_sequences=k,
                      generator=torch.Generator().manual_seed(seed), **kw)
    _pinned_categorical(monkeypatch, _noise_replay(seed, (2 * k, TEXT["vocab_size"]), 6))
    want = jax.jit(lambda p, x, q: jm.generate(p, x, q, do_sample=True, top_p=0.9,
                                               rng=jax.random.PRNGKey(0), **kw))(
        jp, np.repeat(image, k, 0), np.repeat(prompt, k, 0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _grad_tol(g):
    g = np.abs(np.asarray(g, np.float64))
    return 5e-3 * g + max(5e-4 * (g.max() if g.size else 0.0), 1e-8)


def _first_moments(opt_state):
    found = []

    def walk(x):
        if hasattr(x, "mu") and hasattr(x, "nu"):
            found.append(x.mu)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)

    walk(opt_state)
    return found[0]


def _flat_j(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_scst_grad_step_matches_jax(models):
    """One grad step of make_scst_step on both sides (K = 2 sampled rows an
    image, advantages of both signs, an AdamW with clip 1.0 and weight decay
    over a linear schedule): the loss and mean log-prob, every gradient, and
    the params after the update."""
    jm, tm, jp, image = models
    k = 2
    tokens = np.array([[5, 6, 7, 8, EOS, 0, 0, 0], [5, 6, 3, 3, 3, 9, 4, EOS],
                       [5, 6, 8, 7, 9, 4, 4, 4], [5, 6, EOS, 0, 0, 0, 0, 0]])
    adv = np.array([1.0, -0.5, 0.7, -1.2], np.float32)
    kw = dict(prompt_length=2, pad_token_id=PAD, eos_id=EOS, sample_n=k, max_length=8)

    jopt = JO.create_optimizer(jp, lr=j_scheduler(lr=LR, num_training_steps=4),
                               weight_decay=0.01, grad_clip=1.0)
    _, jgrad_step = JS.make_scst_step(jm, jopt, **kw)
    jbatch = {"image": jnp.asarray(image), "tokens": jnp.asarray(tokens),
              "advantages": jnp.asarray(adv)}
    jstate, jmetrics = jax.jit(jgrad_step)((jp, jopt.init(jp), jnp.asarray(0)), jbatch,
                                           jax.random.PRNGKey(0))

    # JAX's gradients, clipped, as its Adam first moment holds them
    jgrads = [np.asarray(x) / (1 - B1) for x in jax.tree.leaves(_first_moments(jstate[1]))]

    from efficientvlm_tpu_torch.train.scheduler import create_scheduler

    tp = params_from_numpy(jp, device="cpu")
    topt = TO.create_optimizer(tp, lr=create_scheduler(lr=LR, num_training_steps=4),
                               weight_decay=0.01, grad_clip=1.0)
    _, tstep = TS.make_scst_step(tm, topt, **kw)
    state = init_pretrain_state(tp, topt)
    batch = {"image": torch.from_numpy(image), "tokens": torch.from_numpy(tokens),
             "advantages": torch.from_numpy(adv)}
    metrics, grads = tstep.loss_and_grads(state, batch)
    for name in ("loss_scst", "mean_logprob"):
        np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), rtol=2e-4,
                                   atol=1e-6)
    tstep.apply(state, grads)
    assert len(state.opt_state["mu"]) == len(jgrads)
    for mu, w in zip(state.opt_state["mu"], jgrads):
        assert (np.abs(mu.numpy() / (1 - B1) - w) <= _grad_tol(w)).all()
    assert state.step == 1 == int(jstate[2])
    for got, w, gw in zip(TO.tree_leaves(state.params), _flat_j(jstate[0]), jgrads):
        w = np.asarray(w, np.float64)
        g = np.abs(np.asarray(gw, np.float64))
        allowed = 5e-4 * np.abs(w) + LR * np.minimum(1.0, _grad_tol(g) / (g + EPS)) + 1e-7
        assert (np.abs(got.detach().numpy() - w) <= allowed).all()


# ---------------------------------------------------------------------------
# --scst through the CLI
# ---------------------------------------------------------------------------

N_IMG = 4


@pytest.fixture(scope="module")
def scst_yaml(tmp_path_factory):
    root = tmp_path_factory.mktemp("scst")
    rng = np.random.RandomState(0)
    imgs = root / "imgs"
    imgs.mkdir()
    for i in range(N_IMG):
        Image.fromarray(np.uint8(rng.rand(40, 40, 3) * 255)).save(imgs / f"{i}.jpg")
    words = "dog cat tree car house bird".split()
    # "picture of" in some images' captions only: the prompt's n-grams earn a
    # reward there, so the advantages are not all zero
    train = [{"image": f"{i}.jpg", "caption": (f"a picture of the {words[(i + j) % 6]}"
                                               if i < 2 else
                                               f"a {words[(i + j) % 6]} near the {words[i]}"),
              "image_id": f"im{i}"} for i in range(N_IMG) for j in range(3)]
    (root / "train.json").write_text(json.dumps(train))
    (root / "val.json").write_text(json.dumps([{"image": "0.jpg"}]))
    import yaml

    with open(os.path.join(ROOT, "configs/tests/Captioning_synth.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(train_file=[str(root / "train.json")], val_file=str(root / "val.json"),
               image_root=str(imgs), num_workers=0, compute_dtype="f32", scst_sample_n=2,
               batch_size_train_scst=6, scst_top_p=0.9, max_length=8, min_length=2)
    path = root / "scst.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(autouse=True)
def _restore_sigterm():
    before = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, before)
    TDC._PREEMPT.clear()


def _recording(monkeypatch):
    """Record each grad step's batch and metrics, and each step generator's
    (seed, epoch, index) and first draw."""
    rec = {"steps": [], "gens": [], "gts": []}
    orig_call, orig_gen = TS.ScstGradStep.__call__, TDC.step_generator
    orig_rewards = TS.ScstRewardCriterion.rewards

    def rewards(self, gt_captions, sampled, greedy=None):
        rec["gts"].append([list(g) for g in gt_captions])
        return orig_rewards(self, gt_captions, sampled, greedy)

    def call(self, state, batch):
        m = orig_call(self, state, batch)
        rec["steps"].append(({k: v.clone() if torch.is_tensor(v) else v
                              for k, v in batch.items()}, {k: float(v) for k, v in m.items()}))
        if rec.get("kill_after") == len(rec["steps"]):
            os.kill(os.getpid(), signal.SIGTERM)
        return m

    def gen(seed, epoch, index, device):
        g = orig_gen(seed, epoch, index, device)
        rec["gens"].append(((seed, epoch, index), g.get_state().clone()))
        return g

    monkeypatch.setattr(TS.ScstGradStep, "__call__", call)
    monkeypatch.setattr(TS.ScstRewardCriterion, "rewards", rewards)
    monkeypatch.setattr(TDC, "step_generator", gen)
    return rec


def _cli(yaml_path, out, *extra):
    return ["--task", "coco_captioning", "--scst", "--config", yaml_path, "--output_dir",
            str(out), "--device", "cpu", "--seed", "3", *extra]


def test_scst_cli_trains_and_resumes(scst_yaml, tmp_path, monkeypatch):
    """Two epochs of the --scst CLI (12 captions of 4 images, batch 6: two
    steps an epoch, K = 2), then the same preempted after epoch 1's first
    step and resumed: the replayed epoch 1 draws from the uninterrupted
    epoch 1's generator states and host draws (its images and the ground
    truths picked), and its first loss equals a step by hand from the saved
    state."""
    rec = _recording(monkeypatch)
    whole = cli_main(_cli(scst_yaml, tmp_path / "whole", "--epoch", "2"))
    assert len(whole["reward_history"]) == 4 and np.isfinite(whole["reward_history"]).all()
    assert whole["state"].step == 4 and [e["steps"] for e in whole["epochs"]] == [2, 2]
    assert all(np.isfinite(m["loss_scst"]) for _, m in rec["steps"])
    assert any(float(b["advantages"].abs().max()) > 0 for b, _ in rec["steps"])
    with open(tmp_path / "whole" / "log.txt") as f:
        assert {"epoch", "scst", "train_reward", "train_loss_scst"} <= set(json.loads(f.readline()))
    whole_steps, whole_gens, whole_gts = list(rec["steps"]), list(rec["gens"]), list(rec["gts"])

    for v in ("steps", "gens", "gts"):
        rec[v].clear()
    rec["kill_after"] = 3
    TDC.install_preemption_handler()
    with pytest.raises(SystemExit) as exc:
        cli_main(_cli(scst_yaml, tmp_path / "cut", "--epoch", "2"))
    assert exc.value.code == 0
    saved = TC.load_pytree(str(tmp_path / "cut" / "training_state_latest.ckpt"))
    assert saved["extra"]["epoch"] == 0 and saved["extra"]["scst"] is True
    rec["kill_after"] = None
    TDC.install_preemption_handler()
    for v in ("steps", "gens", "gts"):
        rec[v].clear()
    resumed = cli_main(_cli(scst_yaml, tmp_path / "cut", "--epoch", "2", "--resume"))
    assert [(e["epoch"], e["steps"]) for e in resumed["epochs"]] == [(1, 2)]
    assert resumed["state"].step == 5  # the replayed epoch ran its first step again
    for (key, gstate), (wkey, wstate) in zip(rec["gens"], whole_gens[2:]):
        assert key == wkey and torch.equal(gstate, wstate)
    assert [k for k, _ in rec["gens"]] == [(3, 1, 0), (3, 1, 1)]
    for (batch, _), (wbatch, _) in zip(rec["steps"], whole_steps[2:]):
        assert torch.equal(batch["image"], wbatch["image"])
    assert rec["gts"] == whole_gts[2:]
    batch = rec["steps"][0][0]

    # the replayed step by hand from the saved state: the same loss
    config = tcfg.load_task_config(scst_yaml, repo_root=ROOT)
    student, _ = TCap.build_models(config)
    l0 = TCap.build_l0(config)
    zs = l0.forward_deterministic({"loga": l0.init(2, device="cpu")["loga"]})
    tok = build_tokenizer("")
    step = TS.ScstGradStep(student, None, prompt_length=len(tok(["a picture of "])["input_ids"][0]) - 1,
                           pad_token_id=tok.pad_token_id, eos_id=tok.sep_token_id, sample_n=2,
                           zs=zs)
    loss, _ = step.loss(saved["state"]["params"], batch)
    assert float(loss) == pytest.approx(rec["steps"][0][1]["loss_scst"], rel=1e-6, abs=1e-7)


def test_jax_scst_replay_redraws_the_host_stream(scst_yaml):
    """JAX's --scst resume (efficientvlm_tpu/drivers/captioning.py:296-303)
    builds its dataset afresh, so a replayed epoch after the first draws its
    ground truths from the seeded generator, not from where the interrupted
    epoch began: here the replayed epoch 1 picks other ground truths than
    the uninterrupted epoch 1 (ROADMAP C). The port saves the generators'
    states (test_scst_cli_trains_and_resumes)."""
    import yaml

    from efficientvlm_tpu.data import datasets as JDS
    from efficientvlm_tpu.data.transforms import ImageTransform as JTransform

    with open(scst_yaml) as f:
        cfg = yaml.safe_load(f)

    def loader():
        ds = JDS.CaptioningSCSTDataset(cfg["train_file"], JTransform.train(32, seed=3),
                                       cfg["image_root"], max_words=12, n_gts=2, seed=3)
        return JDS.SimpleLoader(ds, batch_size=6, shuffle=True, drop_last=True,
                                collate_fn=JDS.scst_collate)

    whole = loader()
    for epoch in range(2):
        whole.set_epoch(epoch)
        gts = [g for _, g in whole]
    replay = loader()
    replay.set_epoch(1)
    assert [g for _, g in replay] != gts
