"""Roofline of the port (port of ``repro.roofline``): the H100's roofline
terms (:mod:`repro_torch.roofline.analysis`) over a traced op stream's
cost (:mod:`repro_torch.roofline.op_cost`), which the dry-run
(``repro_torch.launch.dryrun``) records per rank."""
