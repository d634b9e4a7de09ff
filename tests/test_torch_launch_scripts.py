"""The port's launch scripts (`scripts/run_kitti_lidar4d_torch.sh`,
`scripts/run_kitti_lidar4d_sim_torch.sh`) against the JAX package's
(`scripts/run_kitti_lidar4d.sh`, `scripts/run_kitti_lidar4d_sim.sh`), read
from their text: each runs one `lidar4d_tpu_torch.cli` module, passes the
JAX script's flags with its values (the workspace aside: the port's has a
`_torch` suffix, since the port refuses a workspace holding the JAX
package's checkpoints), passes "$@" on last, and every flag parses in the
port's parser of that CLI. The scripts need KITTI-360, so none runs here."""

import shlex
from pathlib import Path

import pytest

from lidar4d_tpu_torch.cli.config import get_arg_parser
from lidar4d_tpu_torch.cli.main_lidar4d_sim import get_sim_arg_parser

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = {
    "train": ("run_kitti_lidar4d.sh", "run_kitti_lidar4d_torch.sh",
              "lidar4d_tpu_torch.cli.main_lidar4d", get_arg_parser),
    "sim": ("run_kitti_lidar4d_sim.sh", "run_kitti_lidar4d_sim_torch.sh",
            "lidar4d_tpu_torch.cli.main_lidar4d_sim", get_sim_arg_parser),
}


def _command(name):
    """The script's one command as tokens (comments and line continuations
    removed)."""
    lines = [ln.split("#", 1)[0] for ln in (ROOT / "scripts" / name).read_text().splitlines()]
    tokens = shlex.split(" ".join(lines).replace("\\ ", " "))
    assert tokens.count("python") == 1, tokens
    return tokens[tokens.index("python"):]


def _flags(args):
    """{flag: [its values]} of an argument list, in order."""
    out, flag = {}, None
    for a in args:
        if a.startswith("--"):
            flag = a
            out[flag] = []
        else:
            out[flag].append(a)
    return out


@pytest.mark.parametrize("kind", sorted(SCRIPTS))
def test_launch_script_matches_jax(kind):
    jax_name, port_name, module, parser = SCRIPTS[kind]
    jax_cmd, port_cmd = _command(jax_name), _command(port_name)
    assert port_cmd[:3] == ["python", "-m", module]
    assert jax_cmd[:3] == ["python", "-m", module.replace("lidar4d_tpu_torch", "lidar4d_tpu")]
    assert port_cmd[-1] == jax_cmd[-1] == "$@"
    jax_flags, port_flags = _flags(jax_cmd[3:-1]), _flags(port_cmd[3:-1])
    assert list(port_flags) == list(jax_flags)
    for flag, values in jax_flags.items():
        want = [values[0] + "_torch"] if flag == "--workspace" else values
        assert port_flags[flag] == want, flag
    opt = parser().parse_args(port_cmd[3:-1])
    assert opt.workspace == port_flags["--workspace"][0]
    assert opt.config == "configs/kitti360_4950.txt"


@pytest.mark.parametrize("name", [v[1] for v in SCRIPTS.values()])
def test_launch_script_names_only_port_modules(name):
    text = (ROOT / "scripts" / name).read_text()
    modules = [t for t in shlex.split(text, comments=True) if t.startswith("lidar4d_tpu")]
    assert modules and all(m.startswith("lidar4d_tpu_torch.cli.") for m in modules)
    assert "import jax" not in text and "lidar4d_tpu." not in text
