"""Probes of single layers of the port on the card: each module's main()
times the variants of one piece of the decode step and prints one JSON
line per variant (`python -m spittle_tpu_torch.probes.<name>`)."""
