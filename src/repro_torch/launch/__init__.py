"""Launchers: the trainer (:mod:`.train`, over the step builders of
:mod:`.steps` and the meshes of :mod:`.mesh`), the LM server and the
sparse-kernel server (:mod:`.serve`), the telemetry report (:mod:`.report`)
and the card's roofline constants (:mod:`.roofline`, read by the
autoscheduler). The dry-run tables and the steps' abstract arguments wait
for the dry-run (ROADMAP Queue 1 item 7e)."""
