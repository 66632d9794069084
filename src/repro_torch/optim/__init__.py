"""Optimizers of the port: AdamW with 8-bit moments (`adamw`) and int8
gradient compression with error feedback (`compress`)."""
