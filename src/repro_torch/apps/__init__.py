"""The paper's applications (§4): Sobel edge detection and K-means colour
quantisation, with procedural stand-in images and PSNR/SSIM."""
