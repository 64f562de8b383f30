// Reads an image file as the JAX package's loader reads a .hdr / .exr
// name, `cv::imread(p, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)`, through the
// OpenCV it is linked to, for `tools/gen_torch_exr.py`. Built by that
// script with g++:
//
//   g++ -O2 -std=c++17 -I/usr/include/opencv4 cv_read.cpp \
//       -lopencv_imgcodecs -lopencv_core -o cv_read
//
//   cv_read IN OUT.raw
//
// prints `rows cols channels depth` (OpenCV's depth code: 0 CV_8U, 2
// CV_16U, 4 CV_32S, 5 CV_32F, ...) and writes the samples, row by row in
// OpenCV's channel order (B, G, R), to OUT.raw; an empty result prints
// `empty`.

#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>

#include <cstdio>

int main(int argc, char **argv) {
  if (argc != 3) {
    std::fprintf(stderr, "usage: cv_read IN OUT.raw\n");
    return 1;
  }
  cv::Mat m = cv::imread(argv[1], cv::IMREAD_ANYCOLOR | cv::IMREAD_ANYDEPTH);
  if (m.empty()) {
    std::printf("empty\n");
    return 0;
  }
  cv::Mat c = m.isContinuous() ? m : m.clone();
  std::FILE *f = std::fopen(argv[2], "wb");
  if (!f) return 1;
  std::fwrite(c.data, c.elemSize(), c.total(), f);
  std::fclose(f);
  std::printf("%d %d %d %d\n", c.rows, c.cols, c.channels(), c.depth());
  return 0;
}
