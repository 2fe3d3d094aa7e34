"""The benchmark of `rust_raytrace_tpu_torch`: frames rendered back to
back through `Engine.render` on the card, each cell a configuration under
a traffic mix.  `python -m rtbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` runs one cell once (README.md)."""
