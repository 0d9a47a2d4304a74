"""Dataset downloader (counterpart of tpumil/cli/download.py, a mirror of
the reference download.py:28-69): the same dataset names, URLs and unzip
destinations. Host only, no ``--device``:

    python -m tpumil_torch.cli.download --dataset mil|tcga|c16|tcga-test|c16-test
"""

from __future__ import annotations

import argparse
import os
import sys
import urllib.request
import zipfile

DATASETS = {
    # name -> list of (url, zip name, extract dir)  (download.py:33-69)
    "mil": [("https://uwmadison.box.com/shared/static/arvv7f1k8c2m8e2hugqltxgt9zbbpbh2.zip",
             "mil-dataset.zip", "datasets")],
    "tcga": [("https://uwmadison.box.com/shared/static/tze4yqclajbdzjwxyb8b1umfwk9vcdwq.zip",
              "tcga-dataset.zip", "datasets")],
    "c16": [("https://uwmadison.box.com/shared/static/l9ou15iwup73ivdjq0bc61wcg5ae8dwe.zip",
             "c16-dataset.zip", "datasets/Camelyon16")],
    "tcga-test": [
        ("https://uwmadison.box.com/shared/static/q4d9fr93wmllf1navjf2ghc9b0pmzf2a.zip",
         "tcga-dataset-test.zip", "test/input"),
        ("https://uwmadison.box.com/shared/static/grxja488s4i07h9wo3tm4sj6t4nqtz0b.zip",
         "test-weights.zip", "test/weights")],
    "c16-test": [
        ("https://uwmadison.box.com/shared/static/6t7qcmhv5g1a42qaxmuffpvspqzcw1aq.zip",
         "c16-dataset-test.zip", "test-c16/input"),
        ("https://uwmadison.box.com/shared/static/qs717clgaux5hx2mf5qnwmlsoz2elci2.zip",
         "test-weights-c16.zip", "test-c16/weights")],
}


def download_url(url: str, output_path: str) -> None:
    try:
        from tqdm import tqdm

        class Bar(tqdm):
            def update_to(self, b=1, bsize=1, tsize=None):
                if tsize is not None:
                    self.total = tsize
                self.update(b * bsize - self.n)

        with Bar(unit="B", unit_scale=True, miniters=1,
                 desc=url.split("/")[-1]) as t:
            urllib.request.urlretrieve(url, filename=output_path,
                                       reporthook=t.update_to)
    except ImportError:
        urllib.request.urlretrieve(url, filename=output_path)


def unzip_data(zip_path: str, data_path: str) -> None:
    os.makedirs(data_path, exist_ok=True)
    with zipfile.ZipFile(zip_path, "r") as z:
        z.extractall(data_path)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="mil",
                        help="mil|tcga|c16|tcga-test|c16-test")
    args = parser.parse_args(argv)
    if args.dataset not in DATASETS:
        parser.error(f"unknown dataset {args.dataset}; choose from {sorted(DATASETS)}")
    for url, zip_name, dest in DATASETS[args.dataset]:
        print(f"downloading {zip_name}")
        try:
            download_url(url, zip_name)
            unzip_data(zip_name, dest)
            os.remove(zip_name)
        except Exception as e:
            print(f"Download failed ({e}). If the environment has no network "
                  f"egress, fetch {url} manually and unzip to {dest}/.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
