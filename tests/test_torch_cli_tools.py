"""The port's offline CLIs and profiler on the CPU
(efficientvlm_tpu_torch/scripts/export_pruned.py, infer.py;
train/profiler.py), against JAX's scripts run in this process:

- export_pruned on one gated state (tiny towers, head gates one a head,
  log-alphas drawn so that every group prunes), written in each package's
  native format: the sliced tree leaf by leaf and the torch-keyed .th key
  by key equal (within 1e-6) to JAX's scripts/export_pruned.py, for the
  retrieval, captioning and VQA layouts, and the printed parameter counts
  equal;
- on a state whose head gates drive two heads each (the shipped configs'
  head_gate_group: 2) JAX's script fails, the port's exports the gated
  model (ROADMAP C);
- infer on one reference-keyed .th (f32): the captions of a folder and the
  VQA answers equal JAX's scripts/infer.py's;
- profiler.trace on the CPU.
"""

import contextlib
import io
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from efficientvlm_tpu_torch.bridge import params_from_numpy
from efficientvlm_tpu_torch.train import checkpoint as TC

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOM = dict(vision_layers=2, text_layers=2, cross_layers=2, hidden_size=32,
            intermediate_size=64, num_heads=4)


def _run_jax_script(name: str, argv: list) -> str:
    """JAX's scripts/<name>.py as __main__ with argv; its stdout."""
    old = sys.argv
    sys.argv = [name] + argv
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(ROOT, "scripts", f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = old
    return out.getvalue()


def _run_port(module, argv: list) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main(argv)
    return out.getvalue()


def _jax_models(task: str):
    """JAX's tiny model of the task (ViT 32 wide, 2 layers; BERT 32 wide, 4
    layers, fusion 2) and its L0 module, one gate a head."""
    from efficientvlm_tpu import config as jcfg
    from efficientvlm_tpu.models.model_generation import XVLMForCaptioning, XVLMForVQA
    from efficientvlm_tpu.models.model_retrieval import XVLMForRetrieval
    from efficientvlm_tpu.pruning.l0_module import VQAL0Module, XVLML0Module

    vcfg = jcfg.VisionConfig.create(vision_width=32, num_attention_heads=4,
                                    intermediate_size=64, num_hidden_layers=2, image_res=32,
                                    patch_size=8, scan_layers=False)
    tcfg = jcfg.TextConfig.create(vocab_size=200, hidden_size=32, num_hidden_layers=4,
                                  num_attention_heads=4, intermediate_size=64,
                                  encoder_width=32, max_position_embeddings=48,
                                  scan_layers=False)
    config = jcfg.Config({"embed_dim": 16, "num_dec_layers": 2})
    model = {"itr": XVLMForRetrieval, "caption": XVLMForCaptioning,
             "vqa": XVLMForVQA}[task](vcfg, tcfg, config)
    l0 = (VQAL0Module(decoder_layers=2, **GEOM) if task == "vqa" else XVLML0Module(**GEOM))
    return model, l0


def _gated_state(task: str, tmp_path, *, group: int = 1):
    """(JAX-native path, port-native path, numpy snapshot) of one gated
    snapshot {"model", "l0", "epoch"}; with group 2 the head log-alphas are
    half as wide (one gate for two heads)."""
    import jax

    from efficientvlm_tpu.train import checkpoint as JC

    model, l0 = _jax_models(task)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    loga = {}
    for name, g in l0.groups.items():
        shape = list(g["shape"])
        if name.endswith("_head") and group > 1:
            shape[-1] //= group
        loga[name] = rng.uniform(-3, 6, shape).astype(np.float32)
    snap = {"model": params, "l0": {"loga": loga, "lambda_1": np.float32(0.1),
                                    "lambda_2": np.float32(0.2)}, "epoch": 0}
    jpath, tpath = str(tmp_path / f"{task}_jax.ckpt"), str(tmp_path / f"{task}_port.ckpt")
    JC.save_pytree(jpath, snap)
    TC.save_pytree(tpath, {"model": params_from_numpy(params, "cpu"),
                           "l0": params_from_numpy(snap["l0"], "cpu"), "epoch": 0})
    return jpath, tpath, snap


def _cli_geometry(task: str) -> list:
    argv = ["--task", task, "--fusion_layer", "2", "--head_dim", "8"]
    for k, v in GEOM.items():
        argv += [f"--{k}", str(v)]
    if task == "vqa":
        argv += ["--decoder_layers", "2"]
    return argv


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.numpy()}
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("task", ["itr", "caption", "vqa"])
def test_export_pruned_matches_jax(task, tmp_path):
    from efficientvlm_tpu.train import checkpoint as JC
    from efficientvlm_tpu_torch.scripts import export_pruned as EP

    jpath, tpath, _ = _gated_state(task, tmp_path)
    geom = _cli_geometry(task)
    jout = _run_jax_script("export_pruned", ["--training_state", jpath, "--out",
                                             str(tmp_path / "jax_out")] + geom)
    tout = _run_port(EP, ["--training_state", tpath, "--out", str(tmp_path / "port_out")] + geom)
    line = [ln for ln in jout.splitlines() if ln.startswith("params:")]
    assert line and line == [ln for ln in tout.splitlines() if ln.startswith("params:")]
    assert "removed" in line[0] and not line[0].endswith("(0.0% removed)")
    want, got = _flat(JC.load_params(str(tmp_path / "jax_out.ckpt"))), \
        _flat(TC.load_params(str(tmp_path / "port_out.ckpt")))
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].shape == got[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    if task == "itr":  # a text tower: both write the reference's keys
        jsd = torch.load(str(tmp_path / "jax_out.th"))["model"]
        tsd = torch.load(str(tmp_path / "port_out.th"))["model"]
        assert sorted(jsd) == sorted(tsd)
        for k in jsd:
            np.testing.assert_allclose(tsd[k].numpy(), np.asarray(jsd[k]), rtol=0, atol=1e-6,
                                       err_msg=k)
    else:  # no X-VLM keys: JAX's script skips the .th, and so does the port's
        assert not os.path.exists(tmp_path / "jax_out.th")
        assert not os.path.exists(tmp_path / "port_out.th")
        assert "torch export skipped" in jout and "torch export skipped" in tout


def test_jax_export_ignores_head_gate_groups(tmp_path):
    """A state trained with head_gate_group 2 (one log-alpha for two heads):
    JAX's script builds its gates one a head and fails on it; the port's
    reads the grouping from the log-alphas and exports the gated model."""
    import jax

    from efficientvlm_tpu_torch.pruning.export import prune_xvlm_params
    from efficientvlm_tpu_torch.pruning.l0_module import XVLML0Module
    from efficientvlm_tpu_torch.scripts import export_pruned as EP

    jpath, tpath, snap = _gated_state("itr", tmp_path, group=2)
    geom = _cli_geometry("itr")
    with pytest.raises(ZeroDivisionError):  # calculate_model_size over mis-shaped gates
        _run_jax_script("export_pruned", ["--training_state", jpath, "--out",
                                          str(tmp_path / "jax_out")] + geom)
    _run_port(EP, ["--training_state", tpath, "--out", str(tmp_path / "port_out")] + geom)
    l0 = XVLML0Module(head_group=2, **GEOM)
    zs = l0.forward_deterministic({"loga": params_from_numpy(snap["l0"]["loga"], "cpu")})
    assert zs["vision_head_z"].shape == (2, 4)
    want = prune_xvlm_params(params_from_numpy(snap["model"], "cpu"),
                             {k: v.numpy() for k, v in zs.items()}, fusion_layer=2, head_dim=8)
    got = TC.load_params(str(tmp_path / "port_out.ckpt"))
    fw, fg = _flat(want), _flat(got)
    assert sorted(fw) == sorted(fg)
    assert all(np.array_equal(fw[k], fg[k]) for k in fw)
    del jax


# ---------------------------------------------------------------------------
# infer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def infer_files(tmp_path_factory):
    """Three JPEGs, VQA requests and answers, a YAML per package (the synth
    configs in f32) and one reference-keyed .th of a seeded XVLMForPretrain."""
    from efficientvlm_tpu_torch import config as tcfg
    from efficientvlm_tpu_torch.drivers.common import model_configs
    from efficientvlm_tpu_torch.models.model_pretrain import XVLMForPretrain

    d = tmp_path_factory.mktemp("infer")
    imgs = d / "imgs"
    imgs.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(np.uint8(rng.rand(40, 40, 3) * 255)).save(imgs / f"img_{i}.jpg")
    (imgs / "notes.txt").write_text("not an image")
    reqs = [{"image": f"img_{i}.jpg", "question": q}
            for i, q in enumerate(["what color is it?", "how many dogs?", "is it a cat?"])]
    (d / "reqs.jsonl").write_text("\n".join(json.dumps(r) for r in reqs))
    (d / "answers.json").write_text(json.dumps(["red", "blue", "two", "yes", "left side"]))
    files = {"dir": d, "imgs": str(imgs), "reqs": str(d / "reqs.jsonl"),
             "answers": str(d / "answers.json")}
    for task, name in (("caption", "Captioning_synth"), ("vqa", "VQA_synth")):
        with open(os.path.join(ROOT, f"configs/tests/{name}.yaml")) as f:
            cfg = yaml.safe_load(f)
        for pkg, impl in (("jax", "xla"), ("port", "plain")):
            path = d / f"{task}_{pkg}.yaml"
            path.write_text(yaml.safe_dump(dict(cfg, compute_dtype="f32", attn_impl=impl)))
            files[f"{task}_{pkg}"] = str(path)
    config = tcfg.load_task_config(files["caption_port"], repo_root=ROOT)
    vcfg, tcfg_ = model_configs(config)
    params = XVLMForPretrain(vcfg, tcfg_, config).init(5, device="cpu")
    sd = TC.xvlm_state_dict_from_params(params, fusion_layer=tcfg_["fusion_layer"])
    files["th"] = str(d / "xvlm.th")
    torch.save({"model": sd}, files["th"])
    return files


@pytest.mark.parametrize("task", ["caption", "vqa"])
def test_infer_matches_jax(task, infer_files):
    from efficientvlm_tpu_torch.scripts import infer as INF

    f = infer_files
    common = ["--task", task, "--checkpoint", f["th"], "--batch_size", "2"]
    if task == "caption":
        common += ["--images", f["imgs"]]
    else:
        common += ["--requests", f["reqs"], "--answer_list", f["answers"], "--image_root",
                   f["imgs"]]
    jout, tout = str(f["dir"] / f"{task}_jax.json"), str(f["dir"] / f"{task}_port.json")
    _run_jax_script("infer", common + ["--config", f[f"{task}_jax"], "--out", jout])
    _run_port(INF, common + ["--config", f[f"{task}_port"], "--out", tout, "--device", "cpu"])
    with open(jout) as a, open(tout) as b:
        want, got = json.load(a), json.load(b)
    assert got == want and len(got) == 3
    key = "caption" if task == "caption" else "answer"
    assert all(isinstance(r[key], str) for r in got)


def test_infer_runs_on_the_card_by_default(infer_files):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from efficientvlm_tpu_torch.scripts import infer as INF

    with pytest.raises(RuntimeError, match="no CUDA device"):
        INF.main(["--task", "caption", "--checkpoint", infer_files["th"], "--config",
                  infer_files["caption_port"], "--images", infer_files["imgs"]])


# ---------------------------------------------------------------------------
# profiler
# ---------------------------------------------------------------------------


def test_trace_on_the_cpu(tmp_path):
    from efficientvlm_tpu_torch.train import profiler as P

    x = torch.randn(32, 32)
    with P.trace(str(tmp_path / "tr")) as prof:
        for _ in range(3):
            x = torch.tanh(x @ x)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
