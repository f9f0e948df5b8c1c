"""`python -m seaweedfs_tpu_torch.shell` — ops REPL / one-shot command runner.

Port of seaweedfs_tpu/shell/__main__.py: `-master` takes one master or a
raft group (host:port,host:port,...), `-c` runs one command and exits,
and without `-c` the shell reads commands from standard input until EOF,
`exit` or `quit`.
"""

from __future__ import annotations

import argparse
import sys

from .commands import ShellEnv, run_command


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch.shell")
    p.add_argument("-master", default="localhost:9333")
    p.add_argument("-filer", default="localhost:8888")
    p.add_argument("-c", dest="command", default=None, help="run one command and exit")
    a = p.parse_args(argv)

    env = ShellEnv(a.master, a.filer)
    try:
        if a.command:
            print(run_command(env, a.command))
            return 0
        while True:
            try:
                line = input("> ")
            except EOFError:
                return 0
            if line.strip() in ("exit", "quit"):
                return 0
            try:
                print(run_command(env, line))
            except Exception as e:  # keep the REPL alive
                print(f"error: {e}")
    finally:
        env.close()


if __name__ == "__main__":
    sys.exit(main())
