"""The ISAMIR program IR, instruction mapping/selection and the static
scheduler, with the modeled GPU system graph as the target."""
