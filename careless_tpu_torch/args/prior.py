"""Prior flags (same surface as reference careless/args/prior.py)."""
name = "Prior"
description = """
Controls for the prior placed on structure factor amplitudes.
"""

args_and_kwargs = (
    (("--kl-weight",), {
        "help": "Multiply the KL(q||prior) term by this factor and switch "
                "both ELBO terms to mean reductions. When omitted, both "
                "terms are summed, so the balance comes from the data size.",
        "type": float,
        "default": None,
    }),
    (("--wilson-prior-b",), {
        "help": "Apply this Wilson B-factor (Å²) to the prior, giving the "
                "expected resolution falloff exp(-B/4d²). When omitted the "
                "prior is resolution-flat.",
        "type": float,
        "default": None,
    }),
    (("--double-wilson-r",), {
        "help": "Prior correlation between each input file and its parent "
                "in the double-Wilson graph: comma-separated floats, one per "
                "file, 0 for roots, e.g. --double-wilson-r=0.,0.9.",
        "type": str,
        "default": None,
        "dest": "dwr",
    }),
    (("--double-wilson-parents",), {
        "help": "Parent file index for each input in the double-Wilson "
                "graph: comma-separated, 'None' for root nodes, e.g. "
                "--double-wilson-parents=None,0.",
        "type": str,
        "default": None,
        "dest": "parents",
    }),
    (("--double-wilson-reindexing-ops",), {
        "help": "Reindexing operator taking each child's Miller indices "
                "into its parent's ASU, semicolon-delimited, e.g. "
                '--double-wilson-reindexing-ops="x,y,z;x-y,x,z+1/2".',
        "type": str,
        "default": None,
        "dest": "reindexing_ops",
    }),
    (("--analytic-kl",), {
        "help": "Estimate KL(q||prior) with the Rao-Blackwellized "
                "closed-form pieces (truncated-normal entropy + analytic "
                "Wilson cross-entropy terms) instead of pure Monte Carlo. "
                "Lower gradient variance; Wilson priors only (double-Wilson "
                "falls back to Monte Carlo).",
        "action": "store_true",
        "default": False,
    }),
    (("--optimize-double-wilson-r",), {
        "help": "Treat the double-Wilson r values as trainable parameters "
                "(kept in (-1, 1) through a sigmoid).",
        "action": "store_true",
        "default": False,
    }),
)
