"""Positional encoding flags (reference careless/args/positional_encoding.py)."""
name = "Positional Encoding"
description = """
NeRF-style positional encoding of a subset of reflection metadata
(https://arxiv.org/abs/2003.08934). Example:
careless-tpu mono --positional-encoding-keys="XDET,YDET" "Hobs,Kobs,Lobs,BATCH" input.mtz out
"""

args_and_kwargs = (
    (("--positional-encoding-keys",), {
        "help": "Comma separated metadata keys (e.g. \"XDET,YDET\") to encode "
                "separately and append to the rest of the metadata.",
        "type": str,
        "default": None,
    }),
    (("--positional-encoding-frequencies", "-L"), {
        "help": "Number of positional encoding frequencies to apply to "
                "metadata. The default is 4.",
        "type": int,
        "default": 4,
    }),
)
