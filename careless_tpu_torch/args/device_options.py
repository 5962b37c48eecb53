"""Device/runtime flags of the port.

The same flags as careless_tpu/args/device_options.py, so that a command
line of the JAX CLI parses here. The port reads --disable-gpu (the CPU),
--device-id (which card), --num-devices and --shard-axis (one process per
device through torch.distributed), --fused-kernel, --mlp-dtype,
--profile-dir and --seed. The flags that steer only JAX (--run-eagerly,
--platform, --rng-impl, --jax-debug) parse, and a value other than the
default makes careless_tpu_torch.main raise NotImplementedError naming the
flag.
"""
name = "Device Options"
description = None

args_and_kwargs = (
    (("--run-eagerly",), {
        "help": "JAX only: disable jit compilation. The port refuses it.",
        "action": "store_true",
        "default": False,
    }),
    (("--platform",), {
        "help": "JAX only: force a JAX platform. The port refuses it; use "
                "--disable-gpu for the CPU.",
        "type": str,
        "default": None,
    }),
    (("--disable-gpu", "--disable-accelerator"), {
        "help": "Run on the CPU only (the plain PyTorch versions of the "
                "kernels).",
        "action": "store_true",
        "default": False,
    }),
    (("--device-id", "--gpu-id"), {
        "help": "Index of the CUDA device to use. The default is 0.",
        "type": int,
        "default": 0,
        "dest": "device_id",
    }),
    (("--num-devices",), {
        "help": "Train on this many devices, one process each: NCCL on "
                "cards 0 .. N-1, or gloo ranks on the CPU with "
                "--disable-gpu (under torchrun, each process is one "
                "rank). Each rank holds its shard (--shard-axis); rank 0 "
                "writes the outputs. 0 or 1: one device.",
        "type": int,
        "default": 0,
    }),
    (("--shard-axis",), {
        "help": "What --num-devices shards: 'obs' (default) cuts the "
                "observations into contiguous shards (Laue: at harmonic-"
                "chain boundaries); 'mc' gives each device --mc-samples / "
                "N of the Monte Carlo samples over every observation.",
        "type": str,
        "default": "obs",
        "choices": ["obs", "mc"],
    }),
    (("--fused-kernel",), {
        "help": "Use the fused likelihood kernel (K4) for the ELBO inner "
                "loop (Normal/Laplace/StudentT/Ev11 likelihood with an MLP "
                "or hybrid-image scaler). 'auto' (default) takes it at "
                "--mc-samples above 1 from 500,000 observations; 'on' and "
                "'off' force the choice.",
        "type": str,
        "default": "auto",
        "choices": ["auto", "on", "off"],
    }),
    (("--mlp-dtype",), {
        "help": "Matmul precision of the scaling-MLP trunk. 'float32' "
                "(default) matches the reference numerics; 'bfloat16' "
                "rounds the trunk's operands to bf16 and sums in float32.",
        "type": str,
        "default": "float32",
        "choices": ["float32", "bfloat16"],
    }),
    (("--rng-impl",), {
        "help": "JAX only: the JAX PRNG implementation. The port refuses "
                "it (it draws from Philox and a torch.Generator).",
        "type": str,
        "default": None,
        "choices": ["threefry2x32", "rbg", "unsafe_rbg"],
    }),
    (("--profile-dir",), {
        "help": "Record the training loop with torch.profiler and write "
                "its Chrome/TensorBoard trace (*.pt.trace.json) into this "
                "directory. Every event is kept, so the trace grows with "
                "the steps.",
        "type": str,
        "default": None,
    }),
    (("--jax-debug",), {
        "help": "JAX only: increase JAX's log verbosity. The port "
                "refuses it.",
        "action": "store_true",
        "default": False,
    }),
    (("--seed",), {
        "help": "Random number seed for consistent sampling.",
        "type": int,
        "default": 1234,
    }),
)
