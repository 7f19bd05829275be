"""Launchers: the LM server and the sparse-kernel server (:mod:`.serve`),
the telemetry report (:mod:`.report`) and the card's roofline constants
(:mod:`.roofline`, read by the autoscheduler). The trainer and the dry-run
tables wait for the training stack and the dry-run (ROADMAP Queue 1 items
7d and 7e)."""
