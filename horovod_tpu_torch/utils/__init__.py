"""Host-side helpers: retries (``retry``), leveled logging (``logging``),
the Chrome-trace timeline (``timeline``) and the stall inspectors
(``stall``, ``cross_stall``)."""
