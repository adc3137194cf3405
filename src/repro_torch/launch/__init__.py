"""Launchers: the serving loop (``serving``), elastic pod loss and join
(``elastic``), the LM serving launcher (``serve``) and the emulated
meshes (``mesh``)."""
