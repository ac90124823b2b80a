"""Resumable-run id generation (generate_wandb_run_id.py analogue): an
8-char id minted once per output dir so interrupted runs resume logging
under the same identity.

A copy of ``block_transformer_tpu/utils/run_id.py``: the port keeps its own,
as it imports nothing of the JAX package.
"""

import os
import secrets
import string


def generate_run_id(n: int = 8) -> str:
    alphabet = string.ascii_lowercase + string.digits
    return "".join(secrets.choice(alphabet) for _ in range(n))


def get_or_create_run_id(output_dir: str) -> str:
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "run_id.txt")
    if os.path.isfile(path):
        return open(path).read().strip()
    rid = generate_run_id()
    with open(path, "w") as f:
        f.write(rid)
    return rid
