"""``python -m gpubench --workload <cell> --seed <n> --seconds <s> --trace 0|1``."""

import sys

from gpubench.run import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
