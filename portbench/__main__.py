import pathlib
import sys

# Python's bytecode, torch's thousands of modules included, is compiled once
# per checkout into a fixed directory of it and read from there by every
# later run, also where the environment turns bytecode writing off: compiling
# torch from source took most of each run's set-up, at the host's speed.
sys.pycache_prefix = str(pathlib.Path(__file__).resolve().parents[1] / "build" / "pycache")
sys.dont_write_bytecode = False

from portbench.run import main  # noqa: E402

sys.exit(main())
