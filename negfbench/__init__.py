"""negfbench: the benchmark of gaunegf_tpu_torch on the card.

Run one cell with ``python negfbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.
"""
