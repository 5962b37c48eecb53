"""Common flags (same surface as reference careless/args/common.py)."""
name = None
description = None

args_and_kwargs = (
    (("--embed",), {
        "help": "Open an interactive IPython shell once optimization "
                "finishes, with the run state in scope.",
        "action": "store_true",
        "default": False,
    }),
    (("--mc-samples",), {
        "help": "Monte Carlo samples drawn per gradient step to estimate "
                "the ELBO (default 1).",
        "type": int,
        "default": 1,
    }),
    (("--checkpoint-every",), {
        "help": "Save a mid-run training checkpoint (parameters, optimizer "
                "state, step, history) to {output_base}_checkpoint.npz "
                "every N steps (0 = off, the reference behavior: weights "
                "are only written at the end of the run).",
        "type": int,
        "default": 0,
    }),
    (("--resume-from",), {
        "help": "Resume training from a *_checkpoint.npz written by "
                "--checkpoint-every; reproduces the uninterrupted run "
                "exactly (per-step RNG keys are absolute-step-indexed).",
        "type": str,
        "default": None,
    }),
    (("--structure-factor-file",), {
        "help": "Warm-start the structure factor posterior from a "
                "*_structure_factor.npz file written by an earlier run.",
        "type": str,
        "default": None,
    }),
    (("--freeze-structure-factors",), {
        "help": "Keep the structure factor posterior fixed at its initial "
                "(or loaded) values during training.",
        "action": "store_true",
    }),
    (("--structure-factor-init-scale",), {
        "help": "Initial posterior width as a multiple of the prior's "
                "standard deviation (default 1.0).",
        "type": float,
        "default": 1.0,
    }),
    (("--epsilon",), {
        "help": "Stability constant added to the scale of every variational "
                "distribution (default 1e-7).",
        "type": float,
        "default": 1e-7,
    }),
    (("--disable-metadata-standardization",), {
        "help": "Feed metadata to the scaling model as-is instead of "
                "converting each column to z-scores.",
        "action": "store_false",
        "dest": "standardize_metadata",
    }),
    (("--disable-progress-bar",), {
        "help": "Suppress the live training progress bar.",
        "action": "store_true",
        "default": False,
    }),
    (("--save-data-manager",), {
        "help": "Also pickle the DataManager (inputs + ASU collection) next "
                "to the other outputs.",
        "action": "store_true",
        "default": False,
    }),
)
