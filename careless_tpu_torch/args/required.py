"""Required positional arguments (same surface as reference
careless/args/required.py)."""
name = None
description = None

args_and_kwargs = (
    (("metadata_keys",), {
        "help": "Comma-delimited column names fed to the scaling model. "
                "Beyond the file's own columns, the keys "
                "'dHKL,Hobs,Kobs,Lobs,image_id,file_id' are always "
                "available; .stream inputs instead expose "
                "'BATCH,s1x,s1y,s1z,ewald_offset,angular_ewald_offset'.",
        "type": str,
    }),
    (("reflection_files",), {
        "metavar": "reflections.{mtz,stream}",
        "help": "One or more unmerged reflection files (MTZ or CrystFEL "
                ".stream). Stream inputs need --spacegroups since they "
                "carry no symmetry, and are only accepted by the mono "
                "subcommand.",
        "type": str,
        "nargs": "+",
    }),
    (("output_base",), {
        "metavar": "out",
        "help": "Prefix for every output file this run writes.",
        "type": str,
    }),
)
