"""CLI alias: `python -m recalgorithm_tpu_torch.cli.gdcn` trains GDCN
(``cli.main`` with ``--model GDCN`` preset; every flag of ``cli.main``)."""

from recalgorithm_tpu_torch.cli.main import main

if __name__ == "__main__":
    main(model_name="GDCN")
