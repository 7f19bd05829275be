"""Launchers: the trainer (:mod:`.train`, over the step builders of
:mod:`.steps` and the meshes of :mod:`.mesh`), the LM server and the
sparse-kernel server (:mod:`.serve`), the dry-run (:mod:`.dryrun`: one
rank's step of every architecture, shape and mesh counted on ``meta``),
its report and the telemetry report (:mod:`.report`), and the card's
roofline constants with the step's roofline (:mod:`.roofline`, read by
the autoscheduler and the dry-run)."""
