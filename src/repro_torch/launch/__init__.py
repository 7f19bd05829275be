"""Launchers: the sparse-kernel server (:mod:`.serve`) and the telemetry
report (:mod:`.report`). The LM server, the trainer and the dry-run
tables wait for the LM stack (ROADMAP Queue 1 item 7)."""
