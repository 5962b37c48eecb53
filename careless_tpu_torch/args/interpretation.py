"""Data interpretation flags (same surface as reference
careless/args/interpretation.py)."""
name = "Data Interpretation"
description = None

args_and_kwargs = (
    (("--spacegroups",), {
        "help": "Override the symmetry used for merging. Give one spacegroup "
                "for all inputs or a comma-separated list matching the input "
                'files one-to-one, e.g. --spacegroups="P 21 21 21" or '
                '--spacegroups="P 21 21 21,P 1 21 1". Required for .stream '
                "inputs, which carry no symmetry.",
        "type": str,
        "default": None,
    }),
    (("--image-key",), {
        "help": "Column identifying which image/frame each observation came "
                "from. When omitted, the first column with the MTZ BATCH "
                "dtype is picked.",
        "type": str,
        "default": None,
    }),
    (("--intensity-key",), {
        "help": "Column holding the observed intensities. When omitted, the "
                "first column with the MTZ intensity dtype is picked.",
        "type": str,
        "default": None,
    }),
    (("--uncertainty-key",), {
        "help": "Column holding the intensity error estimates. When omitted, "
                "a 'Sig'/'SIG'-prefixed sibling of the intensity column is "
                "tried first, then the first column with the StdDev dtype.",
        "type": str,
        "default": None,
    }),
    (("--anomalous",), {
        "help": "Merge Friedel pairs separately (F+ and F- get their own "
                "posteriors and output columns).",
        "action": "store_true",
        "default": False,
    }),
    (("--separate-files",), {
        "help": "Write one merged output per input file: all inputs share a "
                "single scaling model but keep their own structure factor "
                "sets. Without this flag, every input merges into one output.",
        "action": "store_true",
        "default": False,
    }),
)
