"""How each configuration's system is made and driven: ``configs/<name>.json``
names its module here by ``system``. A system module takes a package
(``package("geosplatting_tpu_torch")``, the program, or the reference's
frozen copy) and builds and drives the same system from either, so the
reference works everything out again from the seed."""
