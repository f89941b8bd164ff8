"""The port's benchmark: `python3 perfbench/run.py --help`."""
