"""Launchers: the serving loop (``serving``), elastic pod loss and join
(``elastic``) and the LM serving launcher (``serve``)."""
