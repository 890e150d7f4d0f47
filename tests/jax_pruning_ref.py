"""JAX's side of the port's distribution tests: the retrieval pruning step
(JAX's make_retrieval_train_step over multihost_check's tiny towers, the
noise and the hard negatives pinned as multihost_check pins them) from
JAX's seeded init, run data parallel under shard_map over two devices or
on one device over the whole batch, and the tolerance its Adam updates
let through.

The port's side (multihost_check, parallel_check --init) starts from the
same init, written by write_port_init.
"""

import functools

import numpy as np

B1, EPS = 0.9, 1e-8
LRS = {"params": 1e-3, "loga": 0.01, "lam": 0.01}  # multihost_check.tiny_config's


def jax_config(jcfg):
    """multihost_check.tiny_config in JAX's config classes (unrolled layers)."""
    vcfg = jcfg.VisionConfig.create(vision_width=64, num_attention_heads=4,
                                    intermediate_size=128, num_hidden_layers=2, image_res=32,
                                    patch_size=8, scan_layers=False)
    tcfg = jcfg.TextConfig.create(vocab_size=128, hidden_size=64, num_hidden_layers=4,
                                  num_attention_heads=4, intermediate_size=128,
                                  encoder_width=64, max_position_embeddings=32,
                                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                                  scan_layers=False)
    return jcfg.Config({"embed_dim": 32, "image_res": 32, "vision": vcfg, "text": tcfg,
                        "teacher_vision": vcfg, "teacher_text": tcfg, "sparsity": 0.25,
                        "optimizer": {"lr": 1e-3, "reg_learning_rate": 0.01,
                                      "weight_decay": 0.01},
                        "schedular": {"num_warmup_steps": 0}})


def _bundle(x):
    import jax

    return jax.tree.map(lambda a: np.array(a, dtype=np.asarray(a).dtype), x)


def jax_init() -> dict:
    """JAX's models, gates and optimizers for the tiny towers, and their
    seeded init as numpy trees."""
    import jax

    from efficientvlm_tpu import config as jcfg
    from efficientvlm_tpu.drivers import common as JC
    from efficientvlm_tpu.drivers.retrieval import build_l0, build_models

    config = jax_config(jcfg)
    (js, jt), jl0 = build_models(config), build_l0(config)
    jl0.lagrangian_warmup = 10
    init = {"student": _bundle(js.init(jax.random.PRNGKey(0))),
            "teacher": _bundle(jt.init(jax.random.PRNGKey(1))),
            "l0": _bundle(jl0.init(jax.random.PRNGKey(2)))}
    return dict(js=js, jt=jt, jl0=jl0, opts=JC.build_optimizers(init["student"], config, 1000),
                init=init)


def write_port_init(path: str, ref: dict) -> str:
    """JAX's init as a port file ({student, teacher, l0}), the --init of
    multihost_check and parallel_check."""
    from efficientvlm_tpu_torch.bridge import params_from_numpy
    from efficientvlm_tpu_torch.train import checkpoint as TC

    TC.save_pytree(path, {k: params_from_numpy(v, "cpu") for k, v in ref["init"].items()})
    return path


def run_steps(ref: dict, steps: int, world_batch: int, devices: int):
    """JAX's step for `steps` steps over multihost_check's world batches:
    under shard_map over `devices` devices as data_parallel_step wraps it
    (the axis index folded into the key), or, with devices=1, on the whole
    batch with no axis. Each side's hard negative is its pair's (i xor 1)
    in the rank's rows, the noise multihost_check's. Returns (per-step
    metrics, per-step states, per-step first moments of the three
    optimizers)."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from efficientvlm_tpu.pruning.l0_module import L0Module as JL0Base
    from efficientvlm_tpu.train import steps as JS
    from efficientvlm_tpu_torch.parallel import multihost_check as M

    js, jt, jl0, opts, init = (ref[k] for k in ("js", "jt", "jl0", "opts", "init"))

    def pick(rng, image_feat, text_feat, *, idx=None, temp):
        pair = jnp.arange(image_feat.shape[0]) ^ 1
        return pair, pair

    for m in (js, jt):
        m.sample_hard_negatives = pick
    axis = "data" if devices > 1 else None
    raw = JS.make_retrieval_train_step(js, jt, jl0, opts, teacher_params=None,
                                       axis_name=axis, impl="xla")

    def body(state, batch, rng, tp, noise):
        jl0.forward_train = functools.partial(JL0Base.forward_train, jl0, noise=noise)
        if axis is not None:
            rng = jax.random.fold_in(rng, jax.lax.axis_index(axis))
        return raw(state, batch, rng, tp)

    if axis is None:
        fn = jax.jit(body)
    else:
        mesh = Mesh(np.asarray(jax.devices()[:devices]), (axis,))
        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P(axis), P(), P(), P()),
                               out_specs=(P(), P()), check_vma=False))
    state = JS.init_train_state(jax.tree.map(jnp.asarray, init["student"]), init["l0"], opts)
    tp = jax.tree.map(jnp.asarray, init["teacher"])
    metrics, states, moments = [], [], []
    for t in range(steps):
        gb = M.world_batch(t, world_batch, "tiny", 128, 32)
        batch = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
                 for k, v in gb.items()}
        noise = {k: jnp.asarray(v) for k, v in M.step_noise(t, jl0.groups).items()}
        state, m = fn(state, batch, jax.random.PRNGKey(7), tp, noise)
        metrics.append({k: float(np.asarray(v)) for k, v in m.items()})
        states.append(state)
        moments.append({name: first_moments(getattr(state, f"{name}_state"))
                        for name in ("opt", "l0", "lam")})
    return metrics, states, moments


def first_moments(opt_state):
    """The first moments (mu) of an optax state, as {path: array}."""
    import jax

    found = []

    def walk(x):
        if hasattr(x, "mu") and hasattr(x, "nu"):
            found.append(x.mu)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)

    walk(opt_state)
    return {key(path): np.asarray(v, np.float64)
            for path, v in jax.tree_util.tree_leaves_with_path(found[0])}


def key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def grad_tol(g) -> np.ndarray:
    """tests/test_torch_train.py's gradient tolerance: 5e-3 |g| + 5e-4 x
    the leaf's largest |g|."""
    g = np.abs(np.asarray(g, np.float64))
    return 5e-3 * g + max(5e-4 * (g.max() if g.size else 0.0), 1e-8)


def update_allowance(moments, group: str, name: str) -> np.ndarray:
    """The parameter disagreement that a gradient tolerance lets through
    Adam's normalised update, summed over the steps: 2 lr * min(1, tol /
    (|g| + eps)) a step, tol = grad_tol(g) (a gradient within tol of zero
    may change sign, which moves Adam's update, about lr * sign(g) in the
    first steps, by up to 2 lr); g of step t from JAX's first moments,
    (mu_t - b1 mu_{t-1}) / (1 - b1)."""
    opt = {"params": "opt", "loga": "l0", "lam": "lam"}[group]
    prev, total = 0.0, 0.0
    for mom in moments:
        mu = mom[opt][name]
        g = np.abs(mu - B1 * prev) / (1 - B1)
        total = total + 2 * LRS[group] * np.minimum(1.0, grad_tol(g) / (g + EPS))
        prev = mu
    return total


def assert_leaves_match(dump: dict, prefix: str, state, moments, atol: float = 1e-4,
                        groups=("params", "loga", "lam")) -> None:
    """The params, log-alphas and λs (or `groups` of them) of a port dump
    (keys <prefix><group>/<path>) against JAX's state: within atol plus the
    update disagreement of `moments`' steps (update_allowance)."""
    import jax

    for group in groups:
        tree = getattr(state, group)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            name = key(path)
            want = np.asarray(leaf, np.float64)
            err = np.abs(dump[f"{prefix}{group}/{name}"] - want)
            allowed = atol + update_allowance(moments, group, name)
            assert (err <= allowed).all(), f"{group}/{name}: max err {err.max():.3e}"
