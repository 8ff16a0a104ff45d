"""Write one cell's input: ``python -m h100_bench.sim CONFIG SEED OUT``.

CONFIG is a configuration file of ``h100_bench/configs/``; its ``sim``
object holds the simulator's parameters.  OUT receives ref.fa(.fai),
reads.bam(.bai) and truth.vcf, the same bytes for the same seed."""

import json
import sys

from h100_bench.sim.simulate import SimConfig, simulate_dataset


def main(argv: list[str]) -> int:
    config, seed, out = argv
    with open(config) as f:
        params = json.load(f)["sim"]
    simulate_dataset(out, SimConfig(**params, seed=int(seed)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
