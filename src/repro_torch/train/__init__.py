"""Training of the port: AdamW (``optimizer``), the train step
(``loop``), checkpoints (``checkpoint``) and failure handling
(``elastic``)."""
