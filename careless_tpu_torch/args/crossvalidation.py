"""Crossvalidation flags (reference careless/args/crossvalidation.py)."""
name = "Crossvalidation"
description = """
Careless-tpu supports two sorts of crossvalidation: a held-out test fraction
for model selection (--test-fraction) and half-dataset merging for data
consistency statistics such as CChalf (--merge-half-datasets).
"""

args_and_kwargs = (
    (("--test-fraction",), {
        "help": "Output model predictions for a held-out fraction of data. "
                "By default, no data will be held out during training.",
        "type": float,
        "default": None,
    }),
    (("--merge-half-datasets",), {
        "help": "After training, split the data in half randomly by image "
                "and merge each half using the frozen scaling model. "
                "Output files have the *_xval_#.mtz suffix.",
        "action": "store_true",
        "default": False,
    }),
    (("--half-dataset-repeats",), {
        "help": "Number of times to repeat the half dataset crossvalidation. "
                "By default this is one.",
        "type": int,
        "default": 1,
    }),
    (("--xval-mode",), {
        "help": "How to execute half-dataset crossvalidation. 'parallel' "
                "(default) trains all 2 x repeats halves together, each "
                "step one pass over every half's rows as one merge over "
                "their stacked structure factors; 'serial' trains them "
                "one after another (the reference's loop). Both use "
                "identical per-half RNG and produce the same merged halves.",
        "type": str,
        "default": "parallel",
        "choices": ["parallel", "serial"],
    }),
    (("--validation-frequency",), {
        "help": "During training, how frequently to evaluate the model on "
                "the test set (integer >= 1, default 10).",
        "type": int,
        "default": 10,
    }),
)
