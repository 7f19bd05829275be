"""Launchers: the sparse-kernel server (:mod:`.serve`), the telemetry
report (:mod:`.report`) and the card's roofline constants
(:mod:`.roofline`, read by the autoscheduler). The LM server, the trainer
and the dry-run tables wait for the LM stack (ROADMAP Queue 1 item 7)."""
