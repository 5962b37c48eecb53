"""The port's argument parser: careless_tpu/parser.py's tree of mono, poly
and devices subcommands built from the same declarative flag groups
(careless_tpu_torch/args), without the JAX runtime settings that parse_args
applies there. The port picks its device in main.run_careless
(--disable-gpu, --device-id)."""
from __future__ import annotations

import argparse
import re
import textwrap
from os.path import exists


class CustomParser(argparse.ArgumentParser):
    def _validate_input_files(self, parser):
        if parser.type == "devices":
            return
        for in_fn in parser.reflection_files:
            if not exists(in_fn):
                self.error(f"Unmerged reflection file {in_fn} does not exist")
            elif in_fn.endswith(".mtz") or in_fn.endswith(".stream"):
                continue
            self.error(
                f"Could not determine filetype for reflection file, {in_fn}. "
                "Please make sure your files end in '.mtz' or '.stream' as "
                "appropriate.")

    def parse_args(self, *args, **kwargs):
        parser = super().parse_args(*args, **kwargs)
        self._validate_input_files(parser)
        return parser


class CustomFormatter(argparse.HelpFormatter):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._whitespace_matcher = re.compile("\n(?!\n)")

    def _fill_text(self, text, width, indent):
        text = re.sub(r"(?!>\n)\n(?!\n)", "", text)
        return textwrap.fill(text, width, initial_indent=indent,
                             subsequent_indent=indent,
                             replace_whitespace=False, drop_whitespace=False)


description = """
Scale and merge crystallographic data by approximate inference — PyTorch and
CUDA on one NVIDIA GPU.
"""

parser = CustomParser(description=description, formatter_class=CustomFormatter)

from . import __version__  # noqa: E402

parser.add_argument("--version", action="version",
                    version=f"careless-tpu-torch {__version__}")

subs = parser.add_subparsers(title="Experiment Type", required=True, dest="type")
mono_sub = subs.add_parser("mono", help="Process monochromatic diffraction data.",
                           formatter_class=CustomFormatter)
poly_sub = subs.add_parser("poly", help="Process polychromatic, 'Laue', "
                                        "diffraction data.",
                           formatter_class=CustomFormatter)
devices_sub = subs.add_parser("devices", help="Print available devices",
                              formatter_class=CustomFormatter)

from .args import device_options, groups, poly, required  # noqa: E402


def _attach(sub, group):
    """Add one declarative flag group to a subparser, as its own --help
    section when the group is named."""
    if group.name is None:
        target = sub
    elif group.description is None:
        target = sub.add_argument_group(group.name)
    else:
        target = sub.add_argument_group(group.name, group.description)
    for flags, kwargs in group.args_and_kwargs:
        target.add_argument(*flags, **kwargs)


for sub in (mono_sub, poly_sub):
    for flags, kwargs in required.args_and_kwargs:
        sub.add_argument(*flags, **kwargs)
    if sub is poly_sub:
        for flags, kwargs in poly.args_and_kwargs:
            sub.add_argument(*flags, **kwargs)
    for group in groups:
        _attach(sub, group)

_attach(devices_sub, device_options)
