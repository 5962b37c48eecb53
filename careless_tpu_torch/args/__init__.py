"""Flag-group registry.

Every module here exports `name` / `description` / `args_and_kwargs`; the
parser attaches each group in `groups` to both the mono and poly
subcommands. `required` (positionals) and `poly` (Laue-only flags) are
wired specially by parser.py. Same CLI surface as the reference's
careless/args package, with device_options replacing tf_options.
"""
from . import common, crossvalidation, device_options, filtration
from . import interpretation, likelihood, optimizer, poly
from . import positional_encoding, prior, required, scaling

# attachment order == --help section order
groups = [common, crossvalidation, filtration, interpretation, likelihood,
          optimizer, positional_encoding, prior, scaling, device_options]
