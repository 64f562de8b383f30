// Writes and reads OpenEXR files through libOpenEXR, for
// `tools/gen_torch_exr.py`, which makes the test files of the port's
// OpenEXR decoder (`vision_tpu_torch/scene/imageio.py` `read_exr`) and the
// decodes they are held against. Built by that script with g++:
//
//   g++ -O2 -std=c++17 -I<OpenEXR> -I<Imath> exr_tool.cpp \
//       -lOpenEXR -lImath -lIex -o exr_tool
//
//   exr_tool write OUT.exr SPEC PLANES.f32
//   exr_tool read IN.exr PLANES.f32
//
// SPEC is one `key=value` a line:
//   width, height, xmin, ymin      the data window
//   channels=R:HALF,G:HALF,...     name:type (HALF, FLOAT, UINT) in the
//                                  order of the planes in PLANES.f32
//   compression=N                  Imf::Compression
//   lineorder=N                    Imf::LineOrder
//   tile=X,Y,MODE,ROUNDING         a tiled file (level mode, rounding mode)
//   layout=scanline|tiled|multipart|deepscanline|deeptiled|yc
//   dwa=LEVEL                      dwaCompressionLevel
// PLANES.f32 holds one float32 [height, width] plane per channel; a UINT
// channel takes each value cast to uint32. The levels of a mip- or ripmap
// other than (0, 0) repeat the top-left corner of level 0. `multipart`
// writes the spec as part 0 and a ZIP scanline part "second" of its
// channels halved after it; `deepscanline` / `deeptiled` write one sample
// a pixel; `yc` writes the R, G, B planes through RgbaOutputFile's
// luminance-chroma mode (Y, RY, BY; RY and BY sub-sampled 2 x 2).
//
// `read` opens the file as OpenCV's EXR decoder does, with Imf::InputFile
// (part 0 of a multi-part file, level (0, 0) of a tiled one), and writes
// each channel of the header (sorted by name) as float32 [height, width]
// through a FLOAT slice; it prints `ok` then `name type xs ys` a channel
// and the data window, or `error <message>` and exits 2 when InputFile
// throws.

#include <ImfChannelList.h>
#include <ImfDeepFrameBuffer.h>
#include <ImfDeepScanLineOutputFile.h>
#include <ImfDeepTiledOutputFile.h>
#include <ImfFrameBuffer.h>
#include <ImfHeader.h>
#include <ImfInputFile.h>
#include <ImfMultiPartOutputFile.h>
#include <ImfOutputFile.h>
#include <ImfOutputPart.h>
#include <ImfPartType.h>
#include <ImfRgbaFile.h>
#include <ImfStandardAttributes.h>
#include <ImfTiledOutputFile.h>
#include <ImfTiledOutputPart.h>
#include <half.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <map>
#include <sstream>
#include <string>
#include <vector>

using namespace Imf;
using namespace Imath;

namespace {

struct Chan {
  std::string name;
  PixelType type;
};

struct Spec {
  int width = 0, height = 0, xmin = 0, ymin = 0;
  std::vector<Chan> chans;
  int compression = 0, lineorder = 0;
  int tx = 0, ty = 0, mode = 0, rounding = 0;
  std::string layout = "scanline";
  float dwa = -1.0f;
};

PixelType parse_type(const std::string &s) {
  if (s == "HALF") return HALF;
  if (s == "FLOAT") return FLOAT;
  if (s == "UINT") return UINT;
  throw std::runtime_error("bad pixel type " + s);
}

const char *type_name(PixelType t) {
  return t == HALF ? "HALF" : t == FLOAT ? "FLOAT" : "UINT";
}

Spec read_spec(const char *path) {
  Spec s;
  std::ifstream f(path);
  std::string line;
  while (std::getline(f, line)) {
    auto eq = line.find('=');
    if (eq == std::string::npos) continue;
    std::string k = line.substr(0, eq), v = line.substr(eq + 1);
    if (k == "width") s.width = std::stoi(v);
    else if (k == "height") s.height = std::stoi(v);
    else if (k == "xmin") s.xmin = std::stoi(v);
    else if (k == "ymin") s.ymin = std::stoi(v);
    else if (k == "compression") s.compression = std::stoi(v);
    else if (k == "lineorder") s.lineorder = std::stoi(v);
    else if (k == "layout") s.layout = v;
    else if (k == "dwa") s.dwa = std::stof(v);
    else if (k == "tile") {
      std::sscanf(v.c_str(), "%d,%d,%d,%d", &s.tx, &s.ty, &s.mode, &s.rounding);
    } else if (k == "channels") {
      std::stringstream ss(v);
      std::string item;
      while (std::getline(ss, item, ',')) {
        auto c = item.find(':');
        s.chans.push_back({item.substr(0, c), parse_type(item.substr(c + 1))});
      }
    }
  }
  return s;
}

// One channel's pixels in its own type, row-major [h, w].
struct Plane {
  std::vector<half> h;
  std::vector<float> f;
  std::vector<uint32_t> u;
  PixelType type;
  char *base(int w, int xmin, int ymin) {
    char *p = type == HALF ? (char *)h.data() : type == FLOAT ? (char *)f.data()
                                                              : (char *)u.data();
    return p - (ptrdiff_t(ymin) * w + xmin) * stride();
  }
  size_t stride() const { return type == HALF ? 2 : 4; }
};

std::vector<Plane> make_planes(const Spec &s, const std::vector<float> &data) {
  std::vector<Plane> planes(s.chans.size());
  size_t n = size_t(s.width) * s.height;
  for (size_t c = 0; c < s.chans.size(); ++c) {
    Plane &p = planes[c];
    p.type = s.chans[c].type;
    for (size_t i = 0; i < n; ++i) {
      float v = data[c * n + i];
      if (p.type == HALF) p.h.push_back(half(v));
      else if (p.type == FLOAT) p.f.push_back(v);
      else p.u.push_back(uint32_t(v));
    }
  }
  return planes;
}

Header make_header(const Spec &s) {
  Box2i dw(V2i(s.xmin, s.ymin), V2i(s.xmin + s.width - 1, s.ymin + s.height - 1));
  Header h(dw, dw);
  h.compression() = Compression(s.compression);
  h.lineOrder() = LineOrder(s.lineorder);
  for (auto &c : s.chans) h.channels().insert(c.name, Channel(c.type));
  if (s.dwa >= 0) h.dwaCompressionLevel() = s.dwa;
  if (s.tx > 0)
    h.setTileDescription(TileDescription(s.tx, s.ty, LevelMode(s.mode),
                                         LevelRoundingMode(s.rounding)));
  return h;
}

FrameBuffer frame(const Spec &s, std::vector<Plane> &planes) {
  FrameBuffer fb;
  for (size_t c = 0; c < planes.size(); ++c) {
    Plane &p = planes[c];
    fb.insert(s.chans[c].name,
              Slice(p.type, p.base(s.width, s.xmin, s.ymin), p.stride(),
                    p.stride() * s.width));
  }
  return fb;
}

void write_tiled(const Spec &s, std::vector<Plane> &planes, const char *out) {
  TiledOutputFile f(out, make_header(s));
  f.setFrameBuffer(frame(s, planes));
  // every level repeats level 0's top-left corner: its frame buffer is
  // level 0's, which covers any smaller level's window
  for (int ly = 0; ly < f.numYLevels(); ++ly)
    for (int lx = 0; lx < f.numXLevels(); ++lx) {
      if (s.mode != RIPMAP_LEVELS && lx != ly) continue;
      f.writeTiles(0, f.numXTiles(lx) - 1, 0, f.numYTiles(ly) - 1, lx, ly);
    }
}

void write_multipart(const Spec &s, std::vector<Plane> &planes, const char *out) {
  Header h0 = make_header(s);
  h0.setName("first");
  h0.setType(s.tx > 0 ? TILEDIMAGE : SCANLINEIMAGE);
  Spec s1 = s;
  s1.width = s.width / 2 + 1;
  s1.height = s.height / 2 + 1;
  s1.tx = 0;
  s1.compression = ZIP_COMPRESSION;
  Header h1 = make_header(s1);
  h1.displayWindow() = h0.displayWindow();  // an attribute parts share
  h1.setName("second");
  h1.setType(SCANLINEIMAGE);
  MultiPartOutputFile f(out, std::vector<Header>{h0, h1}.data(), 2);
  if (s.tx > 0) {
    TiledOutputPart p0(f, 0);
    p0.setFrameBuffer(frame(s, planes));
    p0.writeTiles(0, p0.numXTiles(0) - 1, 0, p0.numYTiles(0) - 1, 0, 0);
  } else {
    OutputPart p0(f, 0);
    p0.setFrameBuffer(frame(s, planes));
    p0.writePixels(s.height);
  }
  OutputPart p1(f, 1);
  // part 1's window is the top-left corner of part 0's planes
  FrameBuffer fb;
  for (size_t c = 0; c < planes.size(); ++c) {
    Plane &p = planes[c];
    fb.insert(s.chans[c].name,
              Slice(p.type, p.base(s.width, s.xmin, s.ymin), p.stride(),
                    p.stride() * s.width));
  }
  p1.setFrameBuffer(fb);
  p1.writePixels(s1.height);
}

void write_deep(const Spec &s, std::vector<Plane> &planes, const char *out) {
  Header h = make_header(s);
  if (s.compression > ZIP_COMPRESSION) h.compression() = ZIPS_COMPRESSION;
  size_t n = size_t(s.width) * s.height;
  std::vector<unsigned int> counts(n, 1);
  std::vector<std::vector<char *>> ptrs(planes.size(), std::vector<char *>(n));
  for (size_t c = 0; c < planes.size(); ++c)
    for (size_t i = 0; i < n; ++i)
      ptrs[c][i] = planes[c].base(s.width, 0, 0) + i * planes[c].stride();
  DeepFrameBuffer fb;
  ptrdiff_t org = ptrdiff_t(s.ymin) * s.width + s.xmin;
  fb.insertSampleCountSlice(Slice(UINT, (char *)(counts.data() - org),
                                  sizeof(unsigned int),
                                  sizeof(unsigned int) * s.width));
  for (size_t c = 0; c < planes.size(); ++c)
    fb.insert(s.chans[c].name,
              DeepSlice(planes[c].type, (char *)(ptrs[c].data() - org),
                        sizeof(char *), sizeof(char *) * s.width,
                        planes[c].stride()));
  if (s.layout == "deepscanline") {
    h.setType(DEEPSCANLINE);
    DeepScanLineOutputFile f(out, h);
    f.setFrameBuffer(fb);
    f.writePixels(s.height);
  } else {
    h.setType(DEEPTILE);
    if (s.tx == 0) h.setTileDescription(TileDescription(8, 8, ONE_LEVEL));
    DeepTiledOutputFile f(out, h);
    f.setFrameBuffer(fb);
    f.writeTiles(0, f.numXTiles(0) - 1, 0, f.numYTiles(0) - 1, 0, 0);
  }
}

void write_yc(const Spec &s, std::vector<Plane> &planes, const char *out) {
  size_t n = size_t(s.width) * s.height;
  std::vector<Rgba> px(n);
  for (size_t i = 0; i < n; ++i) {
    auto get = [&](size_t c) {
      return planes[c].type == HALF ? float(planes[c].h[i]) : planes[c].f[i];
    };
    px[i] = Rgba(get(0), get(1), get(2), 1.0f);
  }
  Box2i dw(V2i(s.xmin, s.ymin), V2i(s.xmin + s.width - 1, s.ymin + s.height - 1));
  Header h(dw, dw);
  h.compression() = Compression(s.compression);
  RgbaOutputFile f(out, h, WRITE_YC);
  f.setFrameBuffer(px.data() - (ptrdiff_t(s.ymin) * s.width + s.xmin), 1,
                   s.width);
  f.writePixels(s.height);
}

int do_write(const char *out, const char *spec_path, const char *data_path) {
  Spec s = read_spec(spec_path);
  size_t n = size_t(s.width) * s.height * s.chans.size();
  std::vector<float> data(n);
  FILE *f = std::fopen(data_path, "rb");
  if (!f || std::fread(data.data(), 4, n, f) != n) {
    std::fprintf(stderr, "cannot read %s\n", data_path);
    return 1;
  }
  std::fclose(f);
  std::vector<Plane> planes = make_planes(s, data);
  if (s.layout == "yc") {
    write_yc(s, planes, out);
  } else if (s.layout == "multipart") {
    write_multipart(s, planes, out);
  } else if (s.layout == "deepscanline" || s.layout == "deeptiled") {
    write_deep(s, planes, out);
  } else if (s.tx > 0) {
    write_tiled(s, planes, out);
  } else {
    OutputFile o(out, make_header(s));
    o.setFrameBuffer(frame(s, planes));
    o.writePixels(s.height);
  }
  return 0;
}

int do_read(const char *in, const char *out) {
  try {
    InputFile f(in);
    Box2i dw = f.header().dataWindow();
    int w = dw.max.x - dw.min.x + 1, h = dw.max.y - dw.min.y + 1;
    const ChannelList &cl = f.header().channels();
    std::vector<std::string> names;
    for (auto it = cl.begin(); it != cl.end(); ++it) names.push_back(it.name());
    std::vector<float> planes(names.size() * size_t(w) * h);
    FrameBuffer fb;
    for (size_t c = 0; c < names.size(); ++c) {
      float *base = planes.data() + c * size_t(w) * h -
                    (ptrdiff_t(dw.min.y) * w + dw.min.x);
      fb.insert(names[c], Slice(FLOAT, (char *)base, 4, 4 * size_t(w)));
    }
    f.setFrameBuffer(fb);
    f.readPixels(dw.min.y, dw.max.y);
    FILE *o = std::fopen(out, "wb");
    std::fwrite(planes.data(), 4, planes.size(), o);
    std::fclose(o);
    std::printf("ok\n");
    for (auto it = cl.begin(); it != cl.end(); ++it)
      std::printf("%s %s %d %d\n", it.name(), type_name(it.channel().type),
                  it.channel().xSampling, it.channel().ySampling);
    std::printf("window %d %d %d %d\n", dw.min.x, dw.min.y, dw.max.x, dw.max.y);
  } catch (const std::exception &e) {
    std::printf("error %s\n", e.what());
    return 2;
  }
  return 0;
}

}  // namespace

int main(int argc, char **argv) {
  if (argc == 5 && std::string(argv[1]) == "write") {
    try {
      return do_write(argv[2], argv[3], argv[4]);
    } catch (const std::exception &e) {
      std::fprintf(stderr, "%s\n", e.what());
      return 1;
    }
  }
  if (argc == 4 && std::string(argv[1]) == "read") return do_read(argv[2], argv[3]);
  std::fprintf(stderr, "usage: exr_tool write OUT SPEC PLANES | read IN PLANES\n");
  return 1;
}
