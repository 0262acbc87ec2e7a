"""The trainers' command lines in the port against the JAX package's:
every option of the JAX PPFT and stage-1 parsers parses in the port's, and
only the flags the port refuses are refused, by name; the PPFT command that
docs/MIGRATION.md documents runs as written, on the CPU at the tiny
configuration."""

import os
import shlex
import shutil

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REALISTIC = os.path.join(REPO, "tests", "torch_port_images", "realistic")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's CPU ops on one thread in this module: the tier-1 run puts
    several test workers on one host, and a thread pool as wide as the host
    in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pretrain_file(path):
    """A stage-1 file with seeded random encoder and decoder weights, so
    that the PPFT loss is not 0 at the start."""
    from aqualora_torch.core.config import EfficientNetConfig
    from aqualora_torch.diffusion.pipeline import init_module_weights
    from aqualora_torch.models.watermark import SecretDecoder, SecretEncoder
    gen = torch.Generator().manual_seed(11)
    enc = SecretEncoder(8, 8, 32, 4)
    dec = SecretDecoder(8, EfficientNetConfig.tiny(), device="cpu")
    init_module_weights(enc, gen)
    init_module_weights(dec, gen)
    torch.save({"sec_encoder": enc.state_dict(),
                "sec_decoder": dec.state_dict()}, path)
    return path


def test_every_jax_option_parses_and_only_five_are_refused():
    """Every option string of JAX's PPFT parser parses in the port's, with
    a value of its type; `refuse_unported` then raises NotImplementedError
    naming the flag for --teacher_int8, --int8_gen, --fsdp, --dataset_name
    and --dataset_config_name only.  `--attention_impl` sdpa and xla are
    refused as the one attention path's; auto and flash pass."""
    from aqualora_torch.train import ppft_train as pt
    from aqualora_tpu.train import ppft_train as jt

    refused = {"--teacher_int8", "--int8_gen", "--fsdp", "--dataset_name",
               "--dataset_config_name"}
    port = pt.build_argparser()
    seen = set()
    for action in jt.build_argparser()._actions:
        for opt in action.option_strings:
            if opt in ("-h", "--help"):
                continue
            seen.add(opt)
            argv = [opt] + _value(action)
            args = port.parse_args(argv)
            if opt in refused:
                with pytest.raises(NotImplementedError, match=opt):
                    pt.refuse_unported(args)
            else:
                pt.refuse_unported(args)
    assert refused <= seen
    ours = {o for a in port._actions for o in a.option_strings}
    assert ours - seen == {"-h", "--help", "--device"}
    for impl in ("sdpa", "xla"):
        with pytest.raises(ValueError, match="one attention path"):
            pt.refuse_unported(port.parse_args(["--attention_impl", impl]))
    pt.refuse_unported(port.parse_args(["--attention_impl", "flash"]))


def test_every_jax_stage1_option_parses_and_only_fsdp_is_refused():
    """The same for stage 1's parser: only --fsdp is refused."""
    from aqualora_torch.train import latent_wm_pretrain as s1
    from aqualora_tpu.train import latent_wm_pretrain as js1

    port = s1.build_argparser()
    seen = set()
    for action in js1.build_argparser()._actions:
        for opt in action.option_strings:
            if opt in ("-h", "--help"):
                continue
            seen.add(opt)
            args = port.parse_args([opt] + _value(action))
            if opt == "--fsdp":
                with pytest.raises(NotImplementedError, match="--fsdp"):
                    s1.refuse_unported(args)
            else:
                s1.refuse_unported(args)
    ours = {o for a in port._actions for o in a.option_strings}
    assert "--fsdp" in seen and ours - seen == {"-h", "--help", "--device"}


def _value(action) -> list:
    """A command-line value of `action`'s type (none for a switch)."""
    if action.nargs == 0:
        return []
    if action.choices:
        return [str(action.default if action.default is not None
                    else action.choices[0])]
    if action.type is int:
        return ["2"]
    if action.type is float:
        return ["0.5"]
    return ["x"]


def _diffusers_dir(root, pipe):
    """A local diffusers-layout checkpoint of a pipeline's weights (no
    LoRA), in the port's safetensors."""
    from aqualora_torch.core import io as tio
    from aqualora_torch.train.ppft_train import split_lora
    for sub, module, skip in (
            ("unet/diffusion_pytorch_model.safetensors", pipe.unet,
             split_lora(pipe.unet)[1]),
            ("vae/diffusion_pytorch_model.safetensors", pipe.vae, ()),
            ("text_encoder/model.safetensors", pipe.clip, ())):
        os.makedirs(os.path.dirname(os.path.join(root, sub)), exist_ok=True)
        tio.save_safetensors({k: v for k, v in module.state_dict().items()
                              if k not in skip}, os.path.join(root, sub))
    return root


def test_documented_ppft_command_runs(tmp_path):
    """docs/MIGRATION.md's stage-2 command with its flags unchanged, on the
    CPU with --tiny, --max_train_steps 2 and temporary paths: the folder
    holds 16 images, so at batch 8 an epoch is 2 steps and
    --validation_epochs 1 validates once; the artifacts are written and
    the sanity inference runs."""
    import aqualora_torch.core.config as tcfg
    from aqualora_torch.diffusion.pipeline import StableDiffusionPipeline
    from aqualora_torch.train import ppft_train as pt

    text = open(os.path.join(REPO, "docs", "MIGRATION.md")).read()
    start = text.index("python -m aqualora_tpu.train.ppft_train")
    cmd = text[start:text.index("```", start)].replace("\\\n", " ").split()
    assert cmd[:3] == ["python", "-m", "aqualora_tpu.train.ppft_train"]
    argv = " ".join(cmd[3:])
    model = _diffusers_dir(str(tmp_path / "sd"), StableDiffusionPipeline(
        tcfg.PipelineConfig.tiny(), device="cpu"))
    data = tmp_path / "images"
    data.mkdir()
    names = sorted(f for f in os.listdir(REALISTIC) if f.endswith(".jpg"))
    with open(data / "metadata.jsonl", "w") as f:
        for i in range(16):
            shutil.copy(os.path.join(REALISTIC, names[i % len(names)]),
                        data / f"{i:02d}.jpg")
            f.write(f'{{"file_name": "{i:02d}.jpg", "text": "photo {i}"}}\n')
    out = str(tmp_path / "output2")
    subst = {"$MODEL_NAME": model, "$TRAIN_DIR": str(data),
             "output2": out, "pretrained_latentwm.pth":
             _pretrain_file(str(tmp_path / "s1.pt"))}
    for k, v in subst.items():
        argv = argv.replace(k, v)
    args = pt.build_argparser().parse_args(
        shlex.split(argv) + ["--tiny", "--max_train_steps", "2", "--device",
                             "cpu", "--report_to", "none"])
    assert (args.lr_scheduler, args.validation_epochs) == (
        "cosine_with_restarts", 1)
    res = pt.run(args)
    assert [v["step"] for v in res["validation"]] == [2]
    assert len(res["history"]) == 2 and res["history"][-1]["ppft_loss"] > 0
    assert 0.0 <= res["sanity_bit_accuracy"] <= 1.0
    assert {"pytorch_lora_weights.safetensors", "mapper.safetensors",
            "msgdecoder.pt"} <= set(os.listdir(out))
