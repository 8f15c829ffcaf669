"""The port's command line against the JAX package's, parser by parser.

For each of the nine subcommands both ``build_parser()`` trees are built
and every action of the subcommand is held to the reference's: its option
strings (a positional by its dest), default, type, choices, nargs,
``required`` and action class.  The port may differ only where
``PORT_ONLY`` names the flag, or ``PORT_CHANGED`` the flag and the
attributes that differ, with its reason."""

import argparse
import importlib

import pytest

SUBCOMMANDS = ("extract-frames", "compute-flow", "extract-features",
               "classify-clip", "serve", "eval-ucf101", "train",
               "convert-weights", "warmup")
COMPUTES = ("compute-flow", "extract-features", "classify-clip", "serve",
            "eval-ucf101", "train", "warmup")
DEVICE = ("the port runs on the card unless told otherwise; the reference "
          "takes its device from JAX's platform")
PORT_ONLY = {
    **{(cmd, ("--device",)): DEVICE for cmd in COMPUTES},
    ("serve", ("--seed",)):
        "picks the seed of the random weights served without --checkpoint; "
        "its default 0 is the reference's fixed seed, so the default "
        "command serves the reference's weights (tests/test_torch_cli.py "
        "uses it)",
}


CLIP_ARCHS = ("adds the video archs r2plus1d_34 (models/video_resnet), "
              "timesformer_base (models/timesformer) and swin3d_b "
              "(models/video_swin), which the reference has not; "
              "classify-clip and eval-ucf101 run their clip volumes")
ARCH_GEOMETRY = ("left unset it is --arch's own (models.two_stream."
                 "arch_input, and the arch's builder for --width): the "
                 "reference's default for its ResNets, 112 / 128 / 33 / 64 "
                 "for r2plus1d_34, 224 / 224 / 9 / 768 for timesformer_base, "
                 "224 / 224 / 33 / 128 for swin3d_b")
PORT_CHANGED = {
    **{(cmd, ("--arch",)): (CLIP_ARCHS, {"choices": [
        "resnet18", "resnet34", "resnet50", "r2plus1d_34",
        "timesformer_base", "swin3d_b"]})
       for cmd in ("classify-clip", "eval-ucf101")},
    **{(cmd, (flag,)): (ARCH_GEOMETRY, {"default": None})
       for cmd in ("classify-clip", "eval-ucf101")
       for flag in ("--crop", "--resize-short", "--window", "--width")},
}


def _subparsers(module: str):
    parser = importlib.import_module(module).build_parser()
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return action.choices
    raise AssertionError(f"{module}: no subcommands")


def _actions(sub):
    """{option strings, or (dest,) of a positional: what parsing with it
    depends on}."""
    return {tuple(a.option_strings) or (a.dest,):
            {"default": a.default, "type": a.type, "choices": a.choices,
             "nargs": a.nargs, "required": a.required,
             "action": type(a).__name__}
            for a in sub._actions}


@pytest.fixture(scope="module")
def parsers():
    return (_subparsers("video_analytics_tpu.cli.main"),
            _subparsers("video_analytics_tpu_torch.cli.main"))


def test_same_subcommands(parsers):
    ref, port = parsers
    assert sorted(ref) == sorted(port) == sorted(SUBCOMMANDS)


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_subcommand_parser_matches_reference(parsers, cmd):
    ref, port = (_actions(p[cmd]) for p in parsers)
    missing = sorted(set(ref) - set(port))
    assert not missing, f"{cmd}: the port lacks {missing}"
    extra = sorted(k for k in set(port) - set(ref)
                   if (cmd, k) not in PORT_ONLY)
    assert not extra, f"{cmd}: port-only flags with no named reason {extra}"
    for key, want in ref.items():
        _, changed = PORT_CHANGED.get((cmd, key), (None, {}))
        assert port[key] == {**want, **changed}, (cmd, key, port[key], want)
    named = {k for c, k in PORT_ONLY if c == cmd}
    assert named <= set(port) - set(ref), (cmd, named)


@pytest.mark.parametrize("cmd", ["classify-clip", "eval-ucf101"])
@pytest.mark.parametrize("arch", ["resnet18", "resnet34", "resnet50"])
def test_arch_geometry_resolves_to_the_reference_default(parsers, cmd,
                                                         arch):
    """The flags ``PORT_CHANGED`` leaves unset give the reference's
    defaults for the reference's archs."""
    import torch

    from video_analytics_tpu_torch.cli.main import (
        _pipeline_config, build_parser)
    from video_analytics_tpu_torch.models.two_stream import TwoStreamModel

    ref = _actions(parsers[0][cmd])
    argv = {"classify-clip": ["classify-clip", "clip.mp4"],
            "eval-ucf101": ["eval-ucf101", "--videos", "v",
                            "--annotations", "a"]}[cmd]
    args = build_parser().parse_args(argv + ["--arch", arch])
    cfg = _pipeline_config(args)
    assert (cfg.preprocess.crop, cfg.preprocess.resize_short, cfg.window) \
        == (ref[("--crop",)]["default"], ref[("--resize-short",)]["default"],
            ref[("--window",)]["default"])
    with torch.device("meta"):
        model = TwoStreamModel.create(width=args.width, arch=arch)
    assert model.spatial.width == ref[("--width",)]["default"]


def test_train_accepts_fold_bn_and_ignores_it():
    """``train --fold-bn`` parses to the same arguments as without it but
    for the flag itself, as in the reference, whose ``cmd_train`` never
    reads it."""
    from video_analytics_tpu_torch.cli.main import build_parser

    argv = ["train", "--videos", "v", "--annotations", "a", "--out", "o"]
    plain = vars(build_parser().parse_args(argv))
    folded = vars(build_parser().parse_args(argv + ["--fold-bn"]))
    assert folded.pop("fold_bn") is True and plain.pop("fold_bn") is False
    assert folded == plain
